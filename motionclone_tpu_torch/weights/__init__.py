"""Weight carriage into the port's modules."""
