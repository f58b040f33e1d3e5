"""Checkpoint / resume.

Port of ``seigen_tpu/utils/checkpoint.py`` (the npz pair).  The state is
flat — (u, s) arrays and the step index — so a checkpoint is one npz with
the same keys as the JAX package's (``u``, ``s``, ``step``, ``meta``,
``extra_*``): a checkpoint written by either package loads in the other.
It is written uncompressed (the JAX package compresses): zlib gains
little on float fields and takes seconds at full width.  Resume is exact:
the staggered state carries all information.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..solver.timestep import State


def _norm(path: str) -> str:
    # np.savez appends '.npz' when absent; normalise so save and load agree
    # on the same file for extension-less paths.
    return path if path.endswith(".npz") else path + ".npz"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_checkpoint(path: str, state: State, step: int,
                    meta: dict | None = None,
                    extras: dict | None = None):
    """``extras``: further named arrays stored beside (u, s), e.g. the
    viscoelastic memory variables; load_checkpoint returns them."""
    path = _norm(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        u=_host(state.u),
        s=_host(state.s),
        step=np.int64(step),
        meta=json.dumps(meta or {}),
        **{f"extra_{k}": _host(v) for k, v in (extras or {}).items()},
    )


def load_checkpoint(path: str, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cuda"
                    ) -> tuple[State, int, dict]:
    """(State on ``device``, step, meta); the extras, as tensors on
    ``device``, are in ``meta["_extras"]``.  ``dtype``: cast the arrays
    to it (default: as stored)."""
    if not os.path.exists(path):
        path = _norm(path)

    def dev(a):
        t = torch.as_tensor(a, device=device)
        return t if dtype is None else t.to(dtype)

    with np.load(path, allow_pickle=False) as z:
        state = State(u=dev(z["u"]), s=dev(z["s"]))
        meta = json.loads(str(z["meta"]))
        extras = {k[len("extra_"):]: dev(z[k])
                  for k in z.files if k.startswith("extra_")}
        if extras:
            meta["_extras"] = extras
        return state, int(z["step"]), meta
