"""Training checkpoints: atomic, resumable, keep-last-N, in the JAX
package's format.

Counterpart of rcot_tpu/utils/checkpoint.py:34-247. A checkpoint is one
.npz of '/'-joined key paths plus a JSON metadata blob under
'__rcot_meta__', with the key paths and layouts of the JAX TrainState
(rcot_tpu/train/steps.py:58-65):

  t_params/..., f_params/...         the two nets (JAX layouts: HWIO convs,
                                     (in, out) linears)
  {t,f}_opt/count                    updates taken (int32)
  {t,f}_opt/hyperparams/learning_rate
  {t,f}_opt/inner_state/0/square_avg/...     RMSprop, one per parameter
  {t,f}_opt/inner_state/0/{count,mu,nu}/...  Adam
  step                               iterations taken (int32)

so a JAX trainer checkpoint resumes here and one written here resumes in
the JAX package. The nets go through compat/jax_params.py's maps; torch's
RMSprop square_avg is the JAX one, and Adam's exp_avg, exp_avg_sq and step
are mu, nu and count.

Writes are atomic (a temporary file, fsync, os.replace); `latest.npz` is a
symlink to the newest; older files of the same run beyond keep_n are
pruned. AsyncCheckpointer writes on a worker thread from a snapshot taken
on the card, and can skip a periodic save while one is still in flight.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..compat.jax_params import (fnet_jax_from_state_dict, fnet_state_dict_from_jax,
                                 tnet_jax_from_state_dict, tnet_state_dict_from_jax,
                                 unflatten)
from ..train.steps import TrainState

META_KEY = "__rcot_meta__"

# per optimizer: its state entries and their key under inner_state/0/
_SLOTS = {torch.optim.RMSprop: (("square_avg", "square_avg"),),
          torch.optim.Adam: (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}


def _nets(state: TrainState):
    """(key prefix, net, optimizer, to-JAX map, from-JAX map) of T and F."""
    return (("t", state.t_net, state.t_opt, tnet_jax_from_state_dict,
             tnet_state_dict_from_jax),
            ("f", state.f_net, state.f_opt, fnet_jax_from_state_dict,
             fnet_state_dict_from_jax))


def _slots(opt: torch.optim.Optimizer):
    for cls, slots in _SLOTS.items():
        if isinstance(opt, cls):
            return slots
    raise ValueError(f"no checkpoint layout for {type(opt).__name__}")


def _updates(opt: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken (every parameter steps together)."""
    for st in opt.state.values():
        return int(st["step"])
    return 0


def snapshot_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as the JAX TrainState's key paths -> contiguous copies in
    JAX layouts, on the state's device: later steps do not change them."""
    flat: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for k, v in tensors.items():
            flat[f"{prefix}/{k}"] = v.detach().clone(memory_format=torch.contiguous_format)

    for tag, net, opt, to_jax, _ in _nets(state):
        cfg = net.cfg
        named = dict(net.named_parameters())
        put(f"{tag}_params", to_jax(named, cfg))
        for slot, key in _slots(opt):
            put(f"{tag}_opt/inner_state/0/{key}",
                to_jax({n: opt.state[p][slot] if p in opt.state else torch.zeros_like(p)
                        for n, p in named.items()}, cfg))
        count = torch.tensor(_updates(opt), dtype=torch.int32)
        flat[f"{tag}_opt/count"] = count
        if isinstance(opt, torch.optim.Adam):
            flat[f"{tag}_opt/inner_state/0/count"] = count.clone()
        flat[f"{tag}_opt/hyperparams/learning_rate"] = torch.tensor(
            opt.param_groups[0]["lr"], dtype=torch.float32)
    flat["step"] = torch.tensor(state.step, dtype=torch.int32)
    return flat


def _real_path(path: str) -> str:
    if os.path.islink(path):
        return os.path.join(os.path.dirname(path), os.readlink(path))
    return path


def save_checkpoint(path: str, flat: Dict[str, torch.Tensor], *,
                    metadata: Optional[Dict] = None, keep_n: int = 0) -> str:
    """Atomically write a snapshot_state() to `path` (.npz appended if
    absent), point `latest.npz` at it and, with keep_n > 0, prune the
    oldest `<run>_step*.npz` beside it."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    payload = {k: v.cpu().numpy() for k, v in flat.items()}
    meta = dict(metadata or {})
    meta["treedef"] = None  # the JAX package rebuilds the tree from a template
    payload[META_KEY] = np.frombuffer(json.dumps(meta, default=str).encode(), np.uint8)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())  # the data is durable before the name is
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    latest = os.path.join(d, "latest.npz")
    if os.path.islink(latest) or os.path.exists(latest):
        os.unlink(latest)
    os.symlink(os.path.basename(path), latest)

    if keep_n > 0:
        base = os.path.basename(path).rsplit("_step", 1)[0]

        def step_of(fname: str) -> int:  # numeric: "step112" sorts after "step80"
            tail = fname[len(base + "_step"):-len(".npz")]
            return int(tail) if tail.isdigit() else -1
        siblings = sorted((f for f in os.listdir(d)
                           if f.startswith(base + "_step") and f.endswith(".npz")),
                          key=step_of)
        for old in siblings[:-keep_n]:
            if old != os.path.basename(path):
                os.unlink(os.path.join(d, old))
    return path


def read_metadata(path: str) -> Dict:
    """The JSON metadata blob (epoch, epoch_step, config, ...) alone."""
    with np.load(_real_path(path)) as z:
        if META_KEY not in z:
            return {}
        return json.loads(bytes(z[META_KEY].tobytes()).decode())


def load_checkpoint(path: str, state: TrainState) -> Dict:
    """Load a checkpoint of either package into `state` in place (the
    parameters keep their identity, so the optimizers stay bound to them);
    returns its metadata. A missing key or a shape that differs raises,
    naming the key."""
    with np.load(_real_path(path)) as z:
        meta = json.loads(bytes(z[META_KEY].tobytes()).decode()) if META_KEY in z else {}
        flat = {k: z[k] for k in z.files if k != META_KEY}

    def tree(prefix):
        lead = prefix + "/"
        sub = {k[len(lead):]: v for k, v in flat.items() if k.startswith(lead)}
        if not sub:
            raise KeyError(f"{path}: checkpoint has no {prefix!r} entries")
        return unflatten(sub)

    for tag, net, opt, _, from_jax in _nets(state):
        cfg = net.cfg
        net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                             from_jax(tree(f"{tag}_params"), cfg).items()}, strict=True)
        count = int(flat[f"{tag}_opt/count"])
        slots = {slot: from_jax(tree(f"{tag}_opt/inner_state/0/{key}"), cfg)
                 for slot, key in _slots(opt)}
        opt.state.clear()
        for n, p in net.named_parameters():
            st = {"step": torch.tensor(float(count))}
            for slot, named in slots.items():
                if tuple(named[n].shape) != tuple(p.shape):
                    raise ValueError(f"{path}: {tag}_opt {slot} of {n!r} has shape "
                                     f"{named[n].shape}, the parameter {tuple(p.shape)}")
                st[slot] = torch.from_numpy(np.array(named[n])).to(p.device)
            opt.state[p] = st
    state.step = int(flat["step"])
    return meta


class AsyncCheckpointer:
    """Checkpoint writes on a worker thread.

    save() takes the snapshot it is given (snapshot_state, copies on the
    card) and returns at once; the copy to the host and the atomic write
    run on the thread, under the next steps. One write at a time: a second
    save() joins the first, or with skip_if_busy=True returns None without
    writing while the first is in flight (a periodic save loses nothing by
    being skipped: the one in flight bounds the lost work). A failure of the
    thread is raised at the next save() or wait().
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save(self, path: str, flat: Dict[str, torch.Tensor], *,
             metadata: Optional[Dict] = None, keep_n: int = 0,
             skip_if_busy: bool = False) -> Optional[str]:
        if skip_if_busy and self.busy:
            return None
        self.wait()

        def work():
            try:
                save_checkpoint(path, flat, metadata=metadata, keep_n=keep_n)
            except BaseException as e:  # raised on the training thread
                self._err = e

        self._thread = threading.Thread(target=work, name="rcot-async-ckpt", daemon=True)
        self._thread.start()
        return path if path.endswith(".npz") else path + ".npz"

    def wait(self) -> None:
        """Join the write in flight, if any; raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
