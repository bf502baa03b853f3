"""State carried across between the reference package and the port.

numpy only — nothing here imports ``repro``.  A facet dict computed by the
JAX package (``{axis: array}``) moves onto a torch device with
:func:`facets_from_numpy` and back with :func:`facets_to_numpy`; a layout
the JAX autotuner chose (its ``LayoutCandidate`` fields) is rebuilt as the
port's candidate with :func:`candidate_from_key`, so the port runs exactly
that layout (``repro_torch.cfa.compile(..., layout=candidate)``).  A
language model's parameters (the reference's ``init_lm`` pytree as numpy
arrays) become the port's ``LM`` with :func:`lm_from_numpy` and go back to
that pytree with :func:`lm_to_numpy`.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.cfa.autotune import LayoutCandidate

__all__ = ["facets_from_numpy", "facets_to_numpy", "candidate_from_key", "lm_from_numpy",
           "lm_to_numpy"]


def facets_from_numpy(
    facets: Mapping[int, np.ndarray], device: "torch.device | str" = "cuda"
) -> dict[int, torch.Tensor]:
    """A facet dict of numpy arrays as tensors on ``device`` (copied)."""
    return {int(k): torch.tensor(np.asarray(v), device=device)
            for k, v in facets.items()}


def facets_to_numpy(facets: Mapping[int, torch.Tensor]) -> dict[int, np.ndarray]:
    """A facet dict of tensors (any device) as host numpy arrays."""
    return {int(k): v.detach().cpu().numpy() for k, v in facets.items()}


def candidate_from_key(
    tile: Sequence[int],
    ext_dirs: "Mapping[int, int] | Sequence[Sequence[int]] | None" = None,
    contiguity: str | None = "intra-tile",
) -> LayoutCandidate:
    """The port's CFA :class:`LayoutCandidate` for a layout given by its
    tile, extension directions and contiguity level (the fields of the
    reference's candidate, e.g. of ``decision.best_cfa().candidate``)."""
    if ext_dirs is not None:
        items = sorted(ext_dirs.items()) if isinstance(ext_dirs, Mapping) else ext_dirs
        ext_dirs = tuple((int(k), int(c)) for k, c in items)
    return LayoutCandidate("cfa", tuple(int(t) for t in tile),
                           ext_dirs=ext_dirs, contiguity=contiguity)


def lm_from_numpy(cfg, params: Mapping[str, Any], device: "torch.device | str" = "cuda",
                  dtype=None):
    """The port's ``LM`` for ``cfg`` holding the reference's parameters.

    ``params`` is the reference's ``init_lm`` pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm`` and
    ``periods``, whose leaves carry a leading ``n_periods`` axis — period
    ``p``'s position ``i`` becomes layer ``p * len(cfg.period) + i`` (with
    its ``gate``, ``norm_x``, ``cross`` and MoE ``ffn`` leaves where the
    layer has them) — and, for an encoder-decoder, ``encoder``: its
    ``layers`` carry a leading ``enc_layers`` axis (layer ``j`` becomes
    ``encoder.layers.j``) beside its ``final_norm``.  A norm's
    ``{"scale": s}`` becomes one parameter.  ``dtype`` None gives a serving
    model, whose matrices are rounded to the compute dtype as the
    reference's per-call cast rounds them; ``dtype=cfg.param_dtype`` a
    training model that keeps the reference's float32 leaves (``LM``).
    Every parameter of the port must be set by exactly one leaf, and every
    leaf must set one."""
    from repro_torch.models.lm import LM

    model = LM(cfg, device=device, dtype=dtype)
    own = dict(model.named_parameters())
    loaded: set[str] = set()

    def put(name: str, arr: np.ndarray) -> None:
        if name not in own or name in loaded:
            raise ValueError(f"parameter {name!r} is not the port's or is set twice")
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != the port's {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(arr).to(p.dtype))
        loaded.add(name)

    def walk(prefix: tuple, tree: Mapping) -> None:
        for key, val in tree.items():
            path = prefix + (str(key),)
            if isinstance(val, Mapping):
                walk(path, val)
                continue
            arr = np.asarray(val)
            if path[-1] == "scale":  # a norm: {"scale": s}
                path = path[:-1]
            if path[0] == "periods":
                i = int(path[1].removeprefix("pos"))
                for p in range(cfg.n_periods):
                    put(".".join(("layers", str(p * len(cfg.period) + i)) + path[2:]), arr[p])
            elif path[:2] == ("encoder", "layers"):
                for j in range(cfg.enc_layers):
                    put(".".join(("encoder", "layers", str(j)) + path[2:]), arr[j])
            else:
                put(".".join(path), arr)

    walk((), params)
    missing = sorted(set(own) - loaded)
    if missing:
        raise ValueError(f"parameters not set by the pytree: {missing}")
    return model


def lm_to_numpy(model) -> dict:
    """The reference's ``init_lm`` pytree of the port's ``LM`` as numpy
    arrays (bfloat16 as float32, which holds it exactly): the inverse of
    :func:`lm_from_numpy`.  Periods (and encoder layers) are stacked on a
    leading axis and a norm becomes ``{"scale": s}``, as
    ``repro_torch.models.lm.param_leaves`` groups them.  A sharded model's
    leaves are gathered whole (every rank of its mesh must call this)."""
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.models.lm import param_leaves

    out: dict = {}
    for leaf in param_leaves(model):
        v = full_tensor(leaf.value()).cpu()
        tree = out
        for key in leaf.path[:-1]:
            tree = tree.setdefault(key, {})
        tree[leaf.path[-1]] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out
