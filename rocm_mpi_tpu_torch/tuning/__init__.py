"""Kernel autotuning — counterpart of rocm_mpi_tpu/tuning/: a persistent,
traffic-gated tuning cache.

The knobs the port's paths take from the JAX package's space (the VMEM
chunk, body_form and pad_pow2, the deep-halo depth k and its wire mode,
the scan chunk q) and the masked_step kernel's run length are tunable
here:

* `tuning.search` / `python -m rocm_mpi_tpu_torch.tuning search` measures
  the admitted space of a key on the card and persists gated winners;
* `tuning.resolve.resolve` is the one consumer every `config="auto"`
  path funnels through (a miss keeps the defaults; on a grid of several
  ranks rank 0 decides for all);
* `tuning.cache` owns the versioned, atomically written, fingerprinted
  document (`output/tuning/cache_torch.json`, the port's own file);
  `tuning.gate` rejects configs over the A_eff byte budget however fast
  they timed.
"""

from rocm_mpi_tpu_torch.tuning.keys import (  # noqa: F401
    CACHE_KIND,
    CACHE_VERSION,
    KNOWN_OPS,
    TuningKey,
    fingerprint,
    key_str,
    parse_key,
    tuning_key,
)

__all__ = [
    "CACHE_KIND",
    "CACHE_VERSION",
    "KNOWN_OPS",
    "TuningKey",
    "fingerprint",
    "key_str",
    "parse_key",
    "tuning_key",
]
