"""Collectives, fusion and packing of the PyTorch port (counterpart of
``horovod_tpu/comm``)."""
