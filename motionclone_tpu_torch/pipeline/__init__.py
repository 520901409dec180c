"""The guided text-to-video sampling pipeline."""
