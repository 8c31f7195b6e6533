"""The persistent tuning cache — counterpart of rocm_mpi_tpu/tuning/cache.py:
the same versioned JSON document, written atomically.

    {"v": 1,
     "kind": "rmt-tuning-cache",
     "entries": {
       "diffusion.vmem_loop|252x252|f32|1x1|cuda": {
         "config":      {"body_form": "eqc", "pad_pow2": false, "chunk": 256},
         "median_us":   …,        # per step, warmup excluded
         "compile_s":   …,        # builds and captures, never timed
         "gate_ratio":  1.0,      # modeled/ideal A_eff at admission
         "fingerprint": {"torch": "…", "backend": "cuda"}
       }, …}}

Contracts:

* **Atomic writes**: a tmp file and os.replace, sorted keys, so a killed
  search never leaves a torn file and identical content is
  byte-identical.
* **Torn or foreign files read as empty**, with one warning and no
  exception: the cache is an accelerator, not a dependency.
* **Stale fingerprints are a miss, never deleted**: an entry measured
  under another torch or on another backend stays on disk. An entry the
  JAX package wrote (fingerprint {"jax", "backend"}) is such a miss.

The default file is `output/tuning/cache_torch.json` under the checkout
(`RMT_TUNING_CACHE` overrides it, the JAX package's env name), apart from
the JAX package's `cache.json`, so the two never share a default file.
stdlib-only: the validate CLI runs without a card.
"""

from __future__ import annotations

import json
import os
import pathlib
import warnings

from rocm_mpi_tpu_torch.tuning.keys import (
    CACHE_KIND,
    CACHE_VERSION,
    TuningKey,
    key_str,
    parse_key,
)

ENV_CACHE_PATH = "RMT_TUNING_CACHE"

# Entry fields and their types: a closed schema, so that validate rejects
# a drifted writer loudly.
_ENTRY_FIELDS = {
    "config": dict,
    "median_us": (int, float),
    "compile_s": (int, float),
    "gate_ratio": (int, float),
    "fingerprint": dict,
}


def default_cache_path() -> str:
    """RMT_TUNING_CACHE, else <checkout>/output/tuning/cache_torch.json."""
    env = os.environ.get(ENV_CACHE_PATH)
    if env:
        return env
    root = pathlib.Path(__file__).resolve().parents[2]
    return str(root / "output" / "tuning" / "cache_torch.json")


def empty_doc() -> dict:
    return {"v": CACHE_VERSION, "kind": CACHE_KIND, "entries": {}}


def load(path=None) -> dict:
    """Read a cache document; a missing file (the cold start), torn JSON
    or a document of another kind or version reads as empty. Never raises."""
    path = path or default_cache_path()
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return empty_doc()
    except (OSError, ValueError) as e:
        warnings.warn(
            f"tuning cache {path} unreadable ({e}); treating as empty — "
            "every lookup is a miss until it is rewritten",
            stacklevel=2,
        )
        return empty_doc()
    if (
        not isinstance(doc, dict)
        or doc.get("kind") != CACHE_KIND
        or doc.get("v") != CACHE_VERSION
        or not isinstance(doc.get("entries"), dict)
    ):
        warnings.warn(
            f"tuning cache {path} is not a v{CACHE_VERSION} {CACHE_KIND} "
            "document; treating as empty",
            stacklevel=2,
        )
        return empty_doc()
    return doc


def lookup(doc: dict, key: TuningKey, fingerprint: dict) -> dict | None:
    """The entry's config for `key`, or None: a missing key, a malformed
    entry, or a stale fingerprint (another torch, another backend, or an
    entry without a torch version). Stale entries stay in place."""
    entry = doc.get("entries", {}).get(key_str(key))
    if not isinstance(entry, dict):
        return None
    config = entry.get("config")
    fp = entry.get("fingerprint")
    if not isinstance(config, dict) or not isinstance(fp, dict):
        return None
    if fp.get("torch") is None or fp.get("torch") != fingerprint.get("torch"):
        return None
    if fp.get("backend") != fingerprint.get("backend"):
        return None
    return dict(config)


def store(path, key: TuningKey, entry: dict) -> None:
    """Insert or replace one entry and rewrite the file atomically."""
    path = str(path or default_cache_path())
    doc = load(path)
    doc["entries"][key_str(key)] = entry
    write_doc(path, doc)


def write_doc(path, doc: dict) -> None:
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def validate_doc(doc, path: str = "<doc>") -> list[str]:
    """Schema problems of one cache document (empty list = valid)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return [f"{path}: not a JSON object"]
    if doc.get("kind") != CACHE_KIND:
        problems.append(f"{path}: kind != {CACHE_KIND!r}")
    if doc.get("v") != CACHE_VERSION:
        problems.append(f"{path}: v != {CACHE_VERSION}")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        return problems + [f"{path}: entries is not an object"]
    for raw_key, entry in sorted(entries.items()):
        where = f"{path}: entry {raw_key!r}"
        try:
            parse_key(raw_key)
        except ValueError as e:
            problems.append(f"{where}: {e}")
            continue
        if not isinstance(entry, dict):
            problems.append(f"{where}: not an object")
            continue
        for field, types in _ENTRY_FIELDS.items():
            if field not in entry:
                problems.append(f"{where}: missing {field!r}")
            elif not isinstance(entry[field], types):
                problems.append(f"{where}: {field!r} has wrong type")
        fp = entry.get("fingerprint")
        if isinstance(fp, dict) and not (
            isinstance(fp.get("torch"), str)
            and isinstance(fp.get("backend"), str)
        ):
            problems.append(f"{where}: fingerprint needs torch+backend strings")
        cfg = entry.get("config")
        if isinstance(cfg, dict):
            for ck, cv in cfg.items():
                if not isinstance(ck, str) or not isinstance(
                    cv, (str, int, float, bool, type(None))
                ):
                    problems.append(
                        f"{where}: config field {ck!r} is not a scalar"
                    )
    return problems
