"""Event log, PCD writer, trajectory metrics, synthetic renderer."""
