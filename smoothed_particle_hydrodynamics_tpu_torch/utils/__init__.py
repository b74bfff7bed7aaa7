"""Kernel build and benchmark helpers."""
