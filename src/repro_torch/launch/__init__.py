"""Serving launchers of the PyTorch port."""
