"""Knobs and device resolution shared by the port's modules."""
