"""``python -m horovod_tpu_torch.runner``: the port's launcher (the
counterpart of ``python -m horovod_tpu.runner``)."""

import sys

from .launch import main

sys.exit(main())
