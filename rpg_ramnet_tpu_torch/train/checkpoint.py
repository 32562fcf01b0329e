"""Checkpoint save and restore, and export to the reference's format.

Counterpart of ``rpg_ramnet_tpu/train/checkpoint.py`` (payload semantics of
RAM_Net/base/base_trainer.py:133-179).  A checkpoint is a directory
``<run_dir>/checkpoint-epoch{E}`` holding ``state.pt`` (the model's and the
optimizer's state dicts) and ``meta.json`` (epoch, monitor_best, config,
log); the best by the monitored metric is copied to ``model_best``.
``async_checkpoint`` writes the files on a background thread.
``export_pth_tar`` writes a ``.pth.tar`` with the upstream parameter
names (``statenetphasedrecurrent.*`` for ERGB2DepthRecurrent, ``unet.*``
for ERGB2Depth: the models' own submodule names), which the reference
implementation and ``compat.load_reference_checkpoint`` load.
``load_any`` also reads the JAX package's Orbax checkpoint directories
(``tree/`` + ``meta.json``) with ``tensorstore``, where it is installed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from os.path import join
from typing import Any, Dict, Optional

import torch


def _to_host(tree):
    """A copy of a (nested) state dict with every tensor on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Writes the run's checkpoints.  use_async: ``save`` copies the
    model's and optimizer's state to the host, then writes the files on a
    background thread while training goes on (JAX: Orbax's
    AsyncCheckpointer, checkpoint.py:30-46); the next save, ``save_best``
    and ``wait`` wait for it first, and re-raise what it raised.  Both
    modes write the same files."""

    def __init__(self, run_dir: str, use_async: bool = False):
        self.run_dir = run_dir
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(run_dir, exist_ok=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, name: str, model, optimizer, *, epoch: int,
             monitor_best: float, config: Dict[str, Any],
             logger: Optional[Dict[str, Any]] = None) -> str:
        self.wait()
        path = join(self.run_dir, name)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        state = _to_host({"state_dict": model.state_dict(),
                          "optimizer": optimizer.state_dict()})
        meta = json.dumps({"epoch": epoch, "monitor_best": float(monitor_best),
                           "config": config, "logger": logger or {}},
                          default=float)

        def write():
            torch.save(state, join(path, "state.pt"))
            with open(join(path, "meta.json"), "w") as f:
                f.write(meta)

        if not self.use_async:
            write()
            return path

        def run():
            try:
                write()
            except Exception as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"save-{name}")
        self._thread.start()
        return path

    def save_best(self, src_name: str) -> None:
        """Copy a checkpoint to model_best (base_trainer.py:154-156)."""
        self.wait()
        dst = join(self.run_dir, "model_best")
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(join(self.run_dir, src_name), dst)


def restore(path: str, model, optimizer=None) -> Dict[str, Any]:
    """Load a checkpoint directory into model (and optimizer); returns its
    meta (epoch, monitor_best, config, logger)."""
    state = torch.load(join(path, "state.pt"), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["state_dict"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    with open(join(path, "meta.json")) as f:
        return json.load(f)


def read_orbax_params(path: str) -> Dict[str, Any]:
    """The ``params`` subtree of a JAX Orbax checkpoint directory as numpy
    arrays keyed by their path below it (list indices as strings): what
    ``compat.params_to_state_dict`` walks.  Reads ``tree/_METADATA``
    (JSON: one entry per leaf, keyed by the leaf's path tuple) and each
    leaf's zarr array in the OCDBT store with ``tensorstore``, which loads
    no JAX; raises ImportError, naming the way round, where tensorstore
    is not installed."""
    tree = join(path, "tree")
    with open(join(tree, "_METADATA")) as f:
        leaves = json.load(f)["tree_metadata"]
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the JAX package's Orbax checkpoint {path} needs "
            "tensorstore, which is not installed here; export it to a "
            ".pth.tar with the JAX package "
            "(rpg_ramnet_tpu.train.checkpoint.export_pth_tar) and load that"
        ) from e
    params: Dict[str, Any] = {}
    base = "file://" + os.path.abspath(tree) + "/"
    for leaf in leaves.values():
        keys = [k["key"] for k in leaf["key_metadata"]]
        if keys[0] != "params":
            continue
        node = params
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = ts.open({
            "driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": base,
                        "path": ".".join(keys)}}).result().read().result()
    return params


def load_any(path: str, model) -> Dict[str, Any]:
    """Load weights into ``model`` from a checkpoint directory of the port
    (``state.pt`` + ``meta.json``), a JAX Orbax directory (``tree/`` +
    ``meta.json``: its params, ``read_orbax_params``) or a reference
    ``.pth.tar``; returns the meta (config, epoch, ...) the checkpoint
    carries.  The counterpart of the JAX ``load_any``."""
    if path.endswith((".pth.tar", ".pth")) or os.path.isfile(path):
        from ..compat import load_reference_checkpoint
        load_reference_checkpoint(model, path)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return {"config": ckpt.get("config"), "epoch": ckpt.get("epoch", 0)}
    if os.path.exists(join(path, "state.pt")):
        return restore(path, model)
    if os.path.isdir(join(path, "tree")):
        from ..compat import params_from_jax
        params_from_jax(model, read_orbax_params(path), type(model).__name__)
        with open(join(path, "meta.json")) as f:
            return json.load(f)
    raise FileNotFoundError(f"no checkpoint at {path}")


def export_pth_tar(path: str, model, arch: str, config: Dict[str, Any],
                   epoch: int = 0, monitor_best: float = float("inf")) -> None:
    """Write a reference-loadable .pth.tar (float32 state dict under the
    upstream module names, base_trainer.py:133-158)."""
    sd = {k: v.detach().float().cpu().contiguous()
          for k, v in model.state_dict().items()}
    torch.save({"arch": arch, "epoch": epoch, "state_dict": sd,
                "monitor_best": monitor_best, "config": config,
                "logger": None, "optimizer": None}, path)
