"""AOT program cache: what a cold build of the engine's programs learned,
kept on disk for the next engine (counterpart of
``paddle_tpu/serving/aot_cache.py``).

The reference persists its compiled XLA executables and a warm boot
loads them instead of compiling. A CUDA graph cannot be written to disk,
so the port's entry records what a cold build of one program learned
instead:

- the program's key (``prefill/64``, ``decode``, ``sample/8``);
- its input and output signature (shape and dtype of each tensor, and
  whether it returns one tensor or a tuple);
- a digest of its output on the zero example inputs, taken from the
  cold build's first replay.

A warm build (``LLMEngine(program_cache=)``) reads the record instead of
discovering it: on CUDA it skips the cold build's two eager warm-up calls
(the output buffers come from the recorded signature, and the capture
runs on the capture stream the process's engines share, whose lazy
set-up a cold build has done), captures, replays once on the zero
example, and holds the replay's output against the recorded digest; a
mismatch drops the entry and builds the program cold. On the CPU, where
a program is its plain function, a warm build skips the cold build's run
on the zero example that makes the record.

- **Fingerprint.** :func:`engine_fingerprint` hashes everything a
  program's record depends on: the model config, the engine geometry
  (slots, pages, buckets, pool dtype, KV cache dtype, the guard), the
  parameter tree (names, shapes, dtypes; never values), torch's and
  CUDA's versions, the device's name and the hash of the kernel library
  (its ``ops/cuda/_build/<hash>/``). Any change makes another fingerprint
  directory: stale entries are never loaded, only orphaned
  (:meth:`AOTProgramCache.evict_stale` removes them).
- **Entries.** One file a program (``<cache_dir>/<fingerprint>/
  <program>.ptprog``), written atomically (a temporary file, then a
  rename), holding a versioned pickle of the record.
- **Degradation.** A torn or unreadable entry is a miss (a
  ``serving.aot_cache_miss`` span; the file is removed, so the cold
  build's store replaces it): the cache can make a boot faster, never
  wrong.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tempfile

import torch

from paddle_tpu_torch.observability import span

__all__ = ["AOTProgramCache", "FORMAT_VERSION", "engine_fingerprint",
           "output_digest", "signature"]

# bump when the on-disk record changes; folded into every fingerprint so
# old trees are orphaned wholesale, never half-read
FORMAT_VERSION = 1


def _library_hash():
    from paddle_tpu_torch.ops.cuda import build
    return build._digest()


def engine_fingerprint(model_config, engine_config, params, device=None):
    """Hex digest naming the program family of one engine. ``params``
    (``{name: tensor}``) contributes structure only: weights can change
    under a fingerprint, since a program reads them where they are."""
    device = torch.device(device) if device is not None else (
        next(iter(params.values())).device if params else
        torch.device("cpu"))
    ec = engine_config
    material = {
        "format": FORMAT_VERSION,
        "model_config": sorted(
            (k, repr(v)) for k, v in vars(model_config).items()
            if not k.startswith("_")),
        "params": [(k, tuple(int(d) for d in v.shape), str(v.dtype))
                   for k, v in sorted(params.items())],
        "engine": (ec.max_num_seqs, ec.page_size, ec.max_model_len,
                   ec.num_pages, tuple(ec.prefill_buckets), str(ec.dtype),
                   getattr(ec, "kv_cache_dtype", None),
                   bool(getattr(ec, "guard", False))),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "kernels": _library_hash(),
    }
    return hashlib.sha256(repr(material).encode()).hexdigest()[:24]


def signature(tensors):
    """``((shape, dtype name), ...)`` of ``tensors``."""
    return tuple((tuple(int(d) for d in t.shape), str(t.dtype))
                 for t in tensors)


def output_digest(outputs):
    """sha256 over the outputs' shapes, dtypes and bytes."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


class AOTProgramCache:
    """Program records under one cache directory.

    Safe to share between engines (and between processes on one host):
    stores are atomic renames, loads never read a half-written entry,
    and two stores of one key are alike."""

    def __init__(self, cache_dir):
        self.cache_dir = str(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        # telemetry (reporting only; the exact counts are the engines')
        self.hit_count = 0
        self.miss_count = 0
        self.store_count = 0
        self.error_count = 0

    # ------------------------------------------------------------ paths
    def _entry_path(self, fingerprint, program):
        safe = "".join(c if (c.isalnum() or c in "._-") else "_"
                       for c in str(program))
        return os.path.join(self.cache_dir, fingerprint, f"{safe}.ptprog")

    def entries(self, fingerprint):
        """Program names persisted under `fingerprint`."""
        d = os.path.join(self.cache_dir, fingerprint)
        try:
            return sorted(f[:-len(".ptprog")] for f in os.listdir(d)
                          if f.endswith(".ptprog"))
        except OSError:
            return []

    # ------------------------------------------------------------- load
    def load(self, fingerprint, program):
        """The record of one program, or None (a miss, or a corrupt entry,
        which is removed)."""
        path = self._entry_path(fingerprint, program)
        try:
            with open(path, "rb") as fh:
                version, record = pickle.load(fh)
            if version != FORMAT_VERSION:
                raise ValueError(f"format {version} != {FORMAT_VERSION}")
            if not isinstance(record, dict) or record.get("program") != \
                    str(program):
                raise ValueError("the record names another program")
        except FileNotFoundError:
            self.miss_count += 1
            return None
        except Exception as e:  # corrupt / incompatible entry
            self.drop(fingerprint, program, why=type(e).__name__)
            return None
        self.hit_count += 1
        return record

    def drop(self, fingerprint, program, why):
        """Remove one entry that failed to load or to check (a
        ``serving.aot_cache_miss`` span)."""
        self.error_count += 1
        with span("serving.aot_cache_miss", program=str(program), why=why):
            pass
        try:
            os.unlink(self._entry_path(fingerprint, program))
        except OSError:
            pass

    # ------------------------------------------------------------ store
    def store(self, fingerprint, program, record):
        """Write one program's record; True on success. Never raises: a
        full disk degrades to "no cache", not a serving failure."""
        entry = self._entry_path(fingerprint, program)
        d = os.path.dirname(entry)
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    pickle.dump((FORMAT_VERSION, dict(record)), fh)
                os.replace(tmp, entry)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except Exception:
            self.error_count += 1
            return False
        self.store_count += 1
        return True

    # ------------------------------------------------------- maintenance
    def evict_stale(self, keep_fingerprint):
        """Remove every fingerprint directory but `keep_fingerprint`;
        returns the evicted fingerprints."""
        evicted = []
        try:
            names = sorted(os.listdir(self.cache_dir))
        except OSError:
            return evicted
        for name in names:
            d = os.path.join(self.cache_dir, name)
            if name == keep_fingerprint or not os.path.isdir(d):
                continue
            shutil.rmtree(d, ignore_errors=True)
            evicted.append(name)
        return evicted

    def stats(self):
        return {"dir": self.cache_dir, "hits": self.hit_count,
                "misses": self.miss_count, "stores": self.store_count,
                "errors": self.error_count}
