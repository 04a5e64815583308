"""The frozen plain-PyTorch reference: the models the configurations
name and the training steps they state.  Imports nothing of the program
and takes nothing it made: the benchmark hands both sides the same
weights and batches, made from the seed."""

from __future__ import annotations

import importlib

import torch


def build(config: dict, device=None,
          channels_last: bool = False) -> torch.nn.Module:
    """The reference model of ``config``, from the ``build`` function of
    ``reference/<arch>.py``, its parameters uninitialized
    (``device="meta"``: shapes alone); ``channels_last`` runs it in
    channels-last memory."""
    module = importlib.import_module(f"{__name__}.{config['arch']}")
    model = module.build(config, device)
    model.channels_last = channels_last
    return model
