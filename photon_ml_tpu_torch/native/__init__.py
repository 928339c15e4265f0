"""The port's native (g++) Avro decoder and writer, loaded with ctypes."""
