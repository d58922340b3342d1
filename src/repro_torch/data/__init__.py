"""Data plane: JSON token tables and the admission pipeline.

``doc_table.py`` encodes documents as columnar token tables;
``pipeline.py`` is the registry-backed ``AdmissionController`` (and the
sharded training-data pipeline built on it).
"""
