"""Atomic, versioned checkpoints with auto-resume."""
