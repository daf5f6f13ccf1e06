"""Atomic checkpoints with retention, takum16 compression and preemption."""
