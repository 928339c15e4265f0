"""Supervised GLM model classes and the legacy training workflow."""
