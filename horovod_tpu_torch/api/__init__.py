"""Handles of the async collectives (counterpart of ``horovod_tpu/api``)."""
