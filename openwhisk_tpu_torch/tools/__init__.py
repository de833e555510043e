"""Operator tools of the PyTorch port."""
