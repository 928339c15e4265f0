"""Part of the PyTorch port; see photon_ml_tpu_torch/__init__.py."""
