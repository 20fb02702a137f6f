"""Seeding, transforms, stats and weight files."""
