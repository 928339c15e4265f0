"""Command-line drivers of the port: libsvm_to_avro, train and score."""
