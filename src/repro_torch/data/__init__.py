"""Data plane: JSON documents as columnar token tables."""
