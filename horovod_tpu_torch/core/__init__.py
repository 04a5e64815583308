"""Process lifecycle, configuration and errors of the PyTorch port
(counterpart of ``horovod_tpu/core``)."""
