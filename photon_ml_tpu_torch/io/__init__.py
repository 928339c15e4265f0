"""Avro I/O of the port: codec, container files and GameDataset ingest."""
