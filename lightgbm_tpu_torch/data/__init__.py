"""Dataset construction and binning."""
