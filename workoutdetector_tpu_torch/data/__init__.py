"""Data: the loader and the datasets the port has."""
