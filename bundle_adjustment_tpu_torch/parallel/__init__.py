"""Distributed execution on ``torch.distributed`` (port of
``bundle_adjustment_tpu.parallel``): process groups and a ``DeviceMesh`` of
ranks, the point-sharded Schur BA and the window-partitioned BA with sim(3)
consensus (``dist_ba``), and matching with the queries or the train bank
split over ranks (``dist_match``).

One rank per shard is the port's analogue of one JAX device per shard.
Every collective is built from ``all_reduce`` and ``broadcast``, the two that
gloo runs on CUDA tensors, except the ring's block rotation, which is a
point-to-point exchange (``dist_match.match_ring``).  The backend follows
from what the ranks hold (``mesh.backend_for``): NCCL when every rank has a
card of its own, gloo when ranks share a card or run on the CPU.
"""
