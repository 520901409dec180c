"""DDIM schedule and motion-guidance math."""
