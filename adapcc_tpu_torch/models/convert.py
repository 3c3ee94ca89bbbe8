"""Carry flax weights and ZeRO-1 state across to the port.

:func:`flax_to_state_dict` turns a flax variable tree, given as nested
dicts of numpy arrays, into a ``state_dict`` for the port's model of the
same name (GPT-2, and the image models MLP, VGG, ResNet and ViT):

- ``Dense.kernel`` is ``[in, out]`` and becomes the transposed ``Linear.weight``;
- ``Conv.kernel`` is ``HWIO`` and becomes the ``OIHW`` ``Conv2d.weight``;
- flax MHA's ``DenseGeneral`` kernels, ``query/key/value [d, h, hd]`` and
  ``out [h, hd, d]``, become ``Linear`` weights ``[h·hd, d]`` and ``[d,
  h·hd]``, their ``[h, hd]`` biases ``[h·hd]``;
- ``LayerNorm``, ``GroupNorm`` and ``BatchNorm`` ``scale`` becomes ``weight``;
- ``Embed.embedding`` becomes ``Embedding.weight``;
- free parameters (ViT's ``cls`` and ``pos``) and the ``batch_stats``
  collection's ``mean`` and ``var`` (BatchNorm's running statistics, the
  port's buffers of those names) keep their names;
- module names (``h{i}``, ``attn``, ``qkv``, ``ln_f``, ``Conv_0``,
  ``BasicBlock_3``, ...) stay as they are.

:func:`flax_paths` is the inverse map, parameter by parameter; the ZeRO-1
flat layout and FSDP's shardings follow it, and :func:`to_flax_layout` /
:func:`from_flax_layout` move a tensor between the two layouts.  :func:`residual_from_jax` carries one
rank's error-feedback residual of the JAX ``DDPTrainer`` across.

Pipeline stages and MoE: :func:`stage_params_from_flax` turns the per-stage
trees of JAX's ``pipe.split_params`` into the port's
:class:`~adapcc_tpu_torch.pipe.partition.PipelineStage` modules, and
:func:`moe_state_dict_from_flax` a flax ``MoEMLP`` tree into the port's
``MoEMLP`` ``state_dict`` (the router's ``[D, E]`` kernel becomes the
``[E, D]`` weight; the stacked ``w1``/``w2`` stay as they are).

Optimizer state: optax's adam state (``count``, ``mu``, ``nu``) is the
port's AdamW state (``step``, ``exp_avg``, ``exp_avg_sq``), both ways, the
first moment in its own dtype (``mu_dtype``): :func:`zero1_state_from_jax`
and :func:`adam_state_to_jax` for the stacked ZeRO-1 pair or one rank's
row, :func:`zero1_snapshot_from_jax` and :func:`zero1_snapshot_to_jax` for
a checkpoint snapshot carrying the ``zero1_layout`` tag.  The flat layouts
match element for element (``parallel/fsdp.py``), so nothing is permuted.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
               "cls": "cls", "pos": "pos", "mean": "mean", "var": "var"}


def to_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """A kernel in the flax leaf's layout (a view): a ``Linear`` weight
    transposed to ``[in, out]``, a ``Conv2d`` weight permuted ``OIHW`` →
    ``HWIO``."""
    return t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def from_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_flax_layout` (a view)."""
    return t.t() if t.dim() == 2 else t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def flax_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The flax leaf's shape of a kernel of torch ``shape``."""
    return tuple(to_flax_layout(torch.empty(shape, device="meta")).shape)


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, narrow back
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))  # a writable, contiguous copy


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax tree: the ``"params"``
    collection alone, or the variables with ``"params"`` and
    ``"batch_stats"`` (which become BatchNorm's buffers)."""
    trees = [params]
    if "params" in params:
        trees = [params["params"]] + ([params["batch_stats"]] if "batch_stats" in params else [])
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            if name not in _LEAF_NAMES:
                raise ValueError(f"unknown flax parameter {prefix}{name}")
            arr = np.asarray(value)
            if name == "kernel" and arr.ndim == 3:
                # DenseGeneral: [h, hd, d] out of the heads, or [d, h, hd] into them
                out_proj = prefix.endswith("out.")
                arr = (arr.reshape(-1, arr.shape[-1]) if out_proj else arr.reshape(arr.shape[0], -1)).T
            elif name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif name == "kernel":
                arr = arr.T
            elif name == "bias" and arr.ndim == 2:
                arr = arr.reshape(-1)
            out[f"{prefix}{_LEAF_NAMES[name]}"] = _tensor_of(arr)

    for tree in trees:
        walk(tree, "")
    return out


def flax_paths(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """``{parameter name: (flax path, transposed)}``: the path of the leaf
    in the flax tree (``("h0", "attn", "qkv", "kernel")``) and whether the
    flax leaf is the torch parameter in another layout (a ``Dense`` or
    ``Conv`` kernel: :func:`to_flax_layout`).  A ``Linear`` or ``Conv2d``
    weight is a ``kernel``, a ``LayerNorm``, ``GroupNorm`` or ``BatchNorm``
    weight a ``scale``, an ``Embedding`` weight an ``embedding``; any other
    parameter (ViT's ``cls``, ``pos``) keeps its name.  Sorting by path
    gives ``jax.tree_util``'s leaf order, which sorts dict keys at every
    level.  (A ``DenseGeneral`` kernel's leaf is its ``Linear`` weight
    transposed, ``[d, h·hd]``: the same elements in the same order as
    flax's ``[d, h, hd]``.)"""
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        mod_name, _, pname = name.rpartition(".")
        mod = modules[mod_name]
        if pname == "bias":
            leaf = "bias"
        elif isinstance(mod, (nn.Linear, nn.Conv2d)) and pname == "weight":
            leaf = "kernel"
        elif isinstance(mod, nn.Embedding):
            leaf = "embedding"
        elif pname == "weight":
            leaf = "scale"
        else:
            leaf = pname
        path = (*mod_name.split("."), leaf) if mod_name else (leaf,)
        out[name] = (path, leaf == "kernel")
    return out


def _adam_state(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state, e.g. ``optax.adamw``'s ``(ScaleByAdamState, EmptyState, EmptyState)``."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def _tensor(a: Any) -> torch.Tensor:
    """A numpy array (bfloat16 included, which numpy only has through
    JAX's ``ml_dtypes``) as a contiguous torch tensor of the same dtype."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def adam_state_from_jax(opt_state: Any, rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The adam part of an optax state (as numpy) → the port's AdamW state
    ``{"step", "exp_avg", "exp_avg_sq"}``, the moments in their own dtypes:
    the stacked ``[world, L]`` rows, or row ``rank``.  Per-rank counts must
    agree."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    counts = np.unique(np.asarray(adam.count))
    if counts.size != 1:
        raise ValueError(f"per-rank Adam step counts differ: {counts}")
    mu, nu = _tensor(adam.mu), _tensor(adam.nu)
    if rank is not None:
        mu, nu = mu[rank].clone(), nu[rank].clone()
    return {"step": torch.tensor(float(counts[0])), "exp_avg": mu, "exp_avg_sq": nu}


def adam_state_to_jax(state: Mapping[str, torch.Tensor], world: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The port's AdamW state → optax's ``{"count", "mu", "nu"}`` as numpy:
    ``count`` int32, a ``[world]`` vector when ``world`` is given (a
    ``vmap``-ed ``tx.init``'s count) else a scalar; ``mu`` float32 holding
    the values exactly (cast it to the JAX state's ``mu_dtype``); ``nu`` as
    it is."""
    count = np.int32(int(state["step"]))
    return {
        "count": np.full((world,), count, np.int32) if world is not None else np.asarray(count),
        "mu": state["exp_avg"].float().cpu().numpy(),
        "nu": state["exp_avg_sq"].float().cpu().numpy(),
    }


def zero1_state_from_jax(master: Any, opt_state: Any, rank: Optional[int] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A JAX ``Zero1Optimizer`` pair as numpy (``jax.device_get`` of
    ``(master [world, N/world], optax adamw state)``) → the port's
    ``(master, AdamW state)``: the float32 master and ``{"step",
    "exp_avg", "exp_avg_sq"}``; with ``rank``, that rank's row of both
    (the per-rank trainer's state)."""
    m = torch.from_numpy(np.array(master, dtype=np.float32, order="C"))
    return (m if rank is None else m[rank].clone()), adam_state_from_jax(opt_state, rank)


def zero1_snapshot_from_jax(master: Any, opt_state: Any, layout: Mapping[str, Any], tx: Any,
                            rank: Optional[int] = None):
    """A JAX ZeRO-1 pair and its ``zero1_layout`` tag → a
    :class:`~adapcc_tpu_torch.checkpoint.TrainCheckpointState` whose
    ``opt_state`` is ``(master, tx([master]).state_dict())`` holding the
    carried state (``tx`` an optimizer factory, e.g. ``adamw(lr)``) and whose
    ``extra`` keeps the tag: the stacked pair, or with ``rank`` its row."""
    from adapcc_tpu_torch.checkpoint import TrainCheckpointState

    m, state = zero1_state_from_jax(master, opt_state, rank)
    optimizer = tx([m])
    optimizer.state[m] = state
    return TrainCheckpointState(params=None, opt_state=(m, optimizer.state_dict()),
                                extra={"zero1_layout": dict(layout)})


def zero1_snapshot_to_jax(snapshot: Any) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict[str, Any]]:
    """The inverse of :func:`zero1_snapshot_from_jax`: ``(master, {"count",
    "mu", "nu"}, layout)`` as numpy, ``count`` a ``[world]`` vector for a
    stacked master."""
    master, sd = snapshot.opt_state
    state = sd["state"][0] if "state" in sd else sd
    world = master.shape[0] if master.dim() == 2 else None
    return master.detach().float().cpu().numpy(), adam_state_to_jax(state, world), dict(
        snapshot.extra["zero1_layout"])


def residual_from_jax(residual: Mapping[str, Any], model: nn.Module, rank: int) -> List[torch.Tensor]:
    """Rank ``rank``'s error-feedback residual of the JAX ``DDPTrainer``
    (its ``_residual``: the flax tree with a leading ``[world]`` dim, float32,
    as numpy) → the port's residual for that rank: one float32 tensor per
    parameter of ``model``, in ``model.parameters()`` order."""

    def row(tree: Mapping[str, Any]) -> Dict[str, Any]:
        return {k: row(v) if isinstance(v, Mapping) else np.asarray(v, dtype=np.float32)[rank]
                for k, v in tree.items()}

    by_name = flax_to_state_dict(row(residual))
    names = [name for name, _ in model.named_parameters()]
    if set(names) != set(by_name):
        raise ValueError(f"residual leaves {sorted(by_name)} do not match the model's {sorted(names)}")
    return [by_name[name] for name in names]


def stage_params_from_flax(stage_trees: List[Mapping[str, Any]], cfg: Any, partition: Any,
                           device: Any = None) -> List[nn.Module]:
    """JAX ``pipe.split_params`` output (one flax tree a stage, as numpy:
    ``wte``/``wpe`` on stage 0, ``h{i}``, ``ln_f`` and ``head_wte`` on the
    last) → the port's per-stage modules on ``device`` (the card when None;
    raises without one), in the trees' dtypes."""
    from adapcc_tpu_torch.comm.mesh import resolve_device
    from adapcc_tpu_torch.pipe.partition import PipelineStage

    device = resolve_device(device)
    stages = []
    for s, tree in enumerate(stage_trees):
        stage = PipelineStage(cfg, partition, s, device="meta")
        own = {k: v.to(device) for k, v in flax_to_state_dict(tree).items()}
        stage.load_state_dict(own, assign=True)
        stages.append(stage)
    return stages


def moe_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``MoEMLP`` tree (with or without ``"params"``, as numpy) →
    the port's ``MoEMLP`` ``state_dict``."""
    if "params" in params:
        params = params["params"]
    return {
        "router.weight": _tensor(np.asarray(params["router"]["kernel"]).T),
        "router.bias": _tensor(params["router"]["bias"]),
        "w1": _tensor(params["w1"]),
        "w2": _tensor(params["w2"]),
    }


def to_flax_variables(model: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`flax_to_state_dict`: ``{"params": ...}`` (and
    ``"batch_stats"`` from BatchNorm's ``mean``/``var`` buffers) as nested
    dicts of float32 numpy copies (bfloat16 widened exactly) in flax's layouts, so a
    seeded port model initializes the JAX package's flax module of the same
    name.  ``DenseGeneral`` kernels and biases (a module with ``n_head``
    whose children are ``query``, ``key``, ``value`` and ``out``) get flax's
    head-split shapes."""
    modules = dict(model.named_modules())

    def put(tree: Dict[str, Any], path: Tuple[str, ...], arr: np.ndarray) -> None:
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = arr

    params: Dict[str, Any] = {}
    for name, (path, transposed) in flax_paths(model).items():
        t = model.get_parameter(name).detach().float().cpu()
        arr = np.array((to_flax_layout(t) if transposed else t).numpy())  # a copy: no view of the model
        parent = modules.get(".".join(path[:-2]))
        heads = getattr(parent, "n_head", None) if len(path) >= 3 else None
        if heads is not None and path[-2] in ("query", "key", "value", "out"):
            if path[-1] == "bias":
                arr = arr.reshape(heads, -1) if path[-2] != "out" else arr
            elif path[-2] == "out":
                arr = arr.reshape(heads, -1, arr.shape[-1])
            else:
                arr = arr.reshape(arr.shape[0], heads, -1)
        put(params, path, arr)
    out: Dict[str, Any] = {"params": params}
    stats: Dict[str, Any] = {}
    for name, buf in model.named_buffers():
        mod_name, _, bname = name.rpartition(".")
        put(stats, (*mod_name.split("."), bname), np.array(buf.detach().float().cpu().numpy()))
    if stats:
        out["batch_stats"] = stats
    return out
