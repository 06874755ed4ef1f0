"""The coarse-to-fine descriptor search (``ops/ann.py``) against the JAX
package's ``ops/ann.py`` on the CPU.

Banks are structured so that the coarse stage ties massively: bank rows
share their first two words (the coarse lanes) in a few dozen groups, so
hundreds of rows sit at each coarse distance and the k-th candidate is
decided by the tie order alone.  Tolerances: indices and distances equal
exactly (every distance is an integer); recall as ``tests/test_ann.py``
measures it (>= 0.97 against the exact 2-NN, >= 0.95 of the planted
matches found).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import ann as jann
from bundle_adjustment_tpu.ops import hamming as jhamming
from bundle_adjustment_tpu_torch.ops import ann, hamming

torch.set_num_threads(1)


def _tied_bank(rng, m, groups):
    """(m, 8) uint32 words whose first two words take one of ``groups``
    values: the coarse distances tie in blocks of about m / groups rows."""
    bank = rng.integers(0, 2 ** 32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    bank[:, :2] = bank[rng.integers(0, groups, m)][:, :2]
    return bank


def _queries(rng, bank, n, flips):
    """Copies of random bank rows with ``flips`` random bits flipped
    (anywhere in the 256), and the rows they came from."""
    src = rng.integers(0, len(bank), n)
    q = bank[src].copy()
    for i in range(n):
        for pos in rng.choice(256, size=flips, replace=False):
            q[i, pos // 32] ^= np.uint32(1 << (pos % 32))
    return q, src


def _port(a):
    return torch.as_tensor(np.ascontiguousarray(a).view(np.int32))


def _jax_knn(q, bank, valid, k):
    out = jann.knn2_coarse_fine(jnp.asarray(q), jnp.asarray(bank),
                                None if valid is None else jnp.asarray(valid), k_candidates=k)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("m,groups,k,with_valid", [
    (1024, 8, 32, False), (3000, 40, 32, True), (777, 3, 16, True), (20, 2, 32, False),
])
def test_knn2_coarse_fine_equals_jax_on_coarse_ties(m, groups, k, with_valid):
    rng = np.random.default_rng(m)
    bank = _tied_bank(rng, m, groups)
    q, _ = _queries(rng, bank, 300, 12)
    valid = rng.random(m) > 0.25 if with_valid else None
    jb, ji, js = _jax_knn(q, bank, valid, k)
    tb, ti, ts = ann.knn2_coarse_fine(_port(q), _port(bank),
                                      None if valid is None else torch.as_tensor(valid),
                                      k_candidates=k)
    assert ti.dtype == torch.int32 and tb.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("max_block", [1, 777, 3000 * 5, ann.MAX_BLOCK])
def test_result_is_independent_of_the_query_chunks(max_block, monkeypatch):
    rng = np.random.default_rng(5)
    bank = _tied_bank(rng, 3000, 10)
    q, _ = _queries(rng, bank, 64, 20)
    valid = torch.as_tensor(rng.random(3000) > 0.1)
    monkeypatch.setattr(ann, "MAX_BLOCK", 1 << 30)
    ref = ann.knn2_coarse_fine(_port(q), _port(bank), valid)
    monkeypatch.setattr(ann, "MAX_BLOCK", max_block)
    out = ann.knn2_coarse_fine(_port(q), _port(bank), valid)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)


def test_match_bank_equals_jax():
    rng = np.random.default_rng(7)
    bank = _tied_bank(rng, 2048, 16)
    q, _ = _queries(rng, bank, 400, 40)
    valid = rng.random(2048) > 0.2
    ji, jm, jd = (np.asarray(a) for a in jann.match_bank(
        jnp.asarray(q), jnp.asarray(bank), jnp.asarray(valid), ratio=0.8))
    ti, tm, td = ann.match_bank(_port(q), _port(bank), torch.as_tensor(valid), ratio=0.8)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert 0 < tm.sum() < len(q)


def test_recall_on_structured_queries():
    """``tests/test_ann.py``'s measure: ORB-like statistics, the true match
    about 30 bits away, non-matches near 128."""
    rng = np.random.default_rng(0)
    bank8 = rng.integers(0, 256, size=(2048, 32), dtype=np.uint8)
    q_src = rng.choice(2048, size=256, replace=False)
    q8 = bank8[q_src].copy()
    for i in range(len(q8)):
        pos = rng.choice(256, size=30, replace=False)
        q8[i, pos // 8] ^= (1 << (pos % 8)).astype(np.uint8)
    bank = hamming.pack_u8_to_u32(torch.as_tensor(bank8))
    q = hamming.pack_u8_to_u32(torch.as_tensor(q8))
    np.testing.assert_array_equal(
        bank.numpy().view(np.uint32), np.asarray(jhamming.pack_u8_to_u32(jnp.asarray(bank8))))

    bex, iex, _ = hamming.knn2(q, bank)
    ba_, ia_, _ = ann.knn2_coarse_fine(q, bank, k_candidates=32)
    agree = (ia_ == iex).numpy()
    assert agree.mean() >= 0.97, agree.mean()
    np.testing.assert_array_equal(ba_.numpy()[agree], bex.numpy()[agree])
    assert (ia_.numpy() == q_src).mean() >= 0.95


def test_popcount_counts_every_bit():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    want = np.array([bin(int(w)).count("1") for w in words])
    np.testing.assert_array_equal(ann.popcount32(_port(words)).numpy(), want)
