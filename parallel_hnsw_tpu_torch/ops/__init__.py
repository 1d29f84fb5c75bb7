"""Kernel wrappers and tensor ops."""
