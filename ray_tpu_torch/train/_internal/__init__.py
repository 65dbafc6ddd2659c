"""Internals of the Train layer: worker group, controller, checkpoint retention."""
