"""Event log and its analytics, PNG and PCD files, debug plots and overlays,
trajectory metrics, synthetic renderer."""
