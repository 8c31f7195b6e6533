"""Bytes of one `masked_step` launch (csrc/stencil.cu `rmt_masked_step`):
the least a launch must move, each input byte read once and each output
byte written once, whatever the kernel reads again.

One step of the unsharded `perf` path reads T and the prepared
coefficient Cm and writes the new T: three fields of the shard.
"""

from __future__ import annotations

import math


def bytes_per_launch(local_shape, itemsize: int) -> int:
    return 3 * math.prod(local_shape) * int(itemsize)
