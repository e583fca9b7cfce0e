"""Pose scoring (numpy, host side)."""
