"""The port's long-drive harnesses, counterparts of the repo's ``tools/``
scripts of the same names, flags and JSON keys:

    python -m bundle_adjustment_tpu_torch.tools.stress
    python -m bundle_adjustment_tpu_torch.tools.dedup_study
    python -m bundle_adjustment_tpu_torch.tools.global_scale_sweep

Each runs on the card unless ``--device cpu`` asks for the CPU."""
