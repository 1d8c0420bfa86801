"""Import and export reference (torch / PyTorch-Lightning) checkpoints.

Counterpart of ``sin_inn_tpu/models/torch_import.py``, its SR half and its
flow half. The reference trains ``SingleVideoINN`` Lightning modules that
hold the network at ``self.inn``; this module maps such a ``state_dict``
onto the params list of the matching
:func:`sin_inn_tpu_torch.models.inn.build_inn_spec` spec (``sr test
--import-torch ckpt`` renders with reference-trained weights, ``sr train
--import-torch`` fine-tunes from them), and writes a params list back out
in the same schema (``sr export``). Two families:

* **IRN** (``InvRescaleNet``): ``operations.{i}.haar_weights`` for each
  parameter-free Haar squeeze (checked against the fixed bank it is built
  from) and ``operations.{i}.{F,G,H}.conv{1..5}.{weight,bias}`` for each
  ``InvBlockExp``'s dense blocks.
* **SRF** (``UncondSRFlow``, a FrEIA ``ReversibleGraphNet``):
  ``module_list.{i}.s{1,2}.{0,2}.{weight,bias}``, the two convolutions of
  each GLOW coupling's ``nn.Sequential(Conv2d, ReLU, Conv2d)`` subnets,
  taken in ascending module index order. The SRF schema is checked
  structurally (coupling count, every tensor's shape, the 3x3 / 1x1
  alternation); buffers of the parameter-free modules are ignored and the
  permutations are rebuilt from their seeds by the spec, as in the JAX
  package.

The port keeps ``torch.nn.Conv2d``'s OIHW weights, so no weight is
transposed either way. Imported params are float32 CPU tensors. A framework
checkpoint on disk takes precedence over ``--import-torch``
(``train/loop.py``): the import seeds a run, resume continues one.

Flow checkpoints are the reference's ``FlowTrainer`` state dicts, the net at
``net.`` (``net.model.`` inside a progressive controller): the MLP's
``nn.Linear`` layers at ``model.model.{2j}`` (a SIREN's sine layers at
``model.{j}.linear``, its last linear bare at ``model.{n}``), the encoding's
buffers at ``encode.<name>`` (``_ENC_BUFFERS``), and for a progressive net
the controller's mask as its stashed counts ``net.mask_stashed`` (a
spatial controller adds ``in_progress``, ``log_buffer``, ``log_counter``).
The port's INR keeps the JAX package's (fan_in, fan_out) layout, so the
mapping is the JAX package's: each linear weight is transposed. The dense
mask is rebuilt from the counts by the reference's ``load_mask`` rule
(:func:`mask_from_counts`); the controller's iteration and block pointers,
which the reference does not save, start fresh, as in a reference reload.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.models.inn import LayerSpec, build_inn_spec, init_inn


class TorchImportError(ValueError):
    """A reference checkpoint did not match the expected schema."""


def _to_tensor(v) -> torch.Tensor:
    """A torch tensor or array-like -> a float32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(v, dtype=torch.float32)


def flatten_checkpoint(ckpt) -> Dict[str, torch.Tensor]:
    """A raw ``state_dict`` or a full Lightning checkpoint dict -> a flat
    ``{key: float32 tensor}`` with the ``inn.`` prefix stripped."""
    if not isinstance(ckpt, dict):
        raise TorchImportError(f"expected a dict checkpoint, got {type(ckpt)}")
    sd = ckpt.get("state_dict", ckpt)
    return {(k[len("inn."):] if k.startswith("inn.") else k): _to_tensor(v)
            for k, v in sd.items()}


def _conv(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """One torch conv at ``prefix`` -> {'w': OIHW, 'b': (O,)}."""
    wk, bk = f"{prefix}.weight", f"{prefix}.bias"
    for k in (wk, bk):
        if k not in sd:
            raise TorchImportError(f"missing key {k!r}")
    w = sd[wk]
    if w.dim() != 4:
        raise TorchImportError(f"{wk}: expected a 4-D conv weight, got "
                               f"shape {tuple(w.shape)}")
    return {"w": w.contiguous(), "b": sd[bk]}


def _expected_haar_bank(c: int) -> torch.Tensor:
    """The fixed grouped-conv bank of the Haar squeeze: 4 filters [ll, lh,
    hl, hh] of +-1, tiled per input channel; shape (4c, 1, 2, 2)."""
    f = torch.ones((4, 1, 2, 2))
    f[1, 0, 0, 1] = f[1, 0, 1, 1] = -1.0
    f[2, 0, 1, 0] = f[2, 0, 1, 1] = -1.0
    f[3, 0, 1, 0] = f[3, 0, 0, 1] = -1.0
    return torch.cat([f] * c, dim=0)


def _param_shapes(spec: Sequence[LayerSpec], c_in: int):
    """The params list ``init_inn`` builds for the spec (on the CPU)."""
    return init_inn(torch.Generator().manual_seed(0), spec, c_in=c_in)


def _leaves(tree, path=()):
    """(path, tensor) of every leaf of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k],
                                                               path + (k,))]
    return [(path, tree)]


def _check_shapes(layer_idx: int, got: Dict, want: Dict) -> None:
    gl, wl = _leaves(got), _leaves(want)
    if len(gl) != len(wl):
        raise TorchImportError(f"layer {layer_idx}: {len(gl)} tensors "
                               f"imported, expected {len(wl)}")
    for (pg, g), (pw, w) in zip(gl, wl):
        if pg != pw or tuple(g.shape) != tuple(w.shape):
            raise TorchImportError(
                f"layer {layer_idx}: param {'.'.join(pg)} has shape "
                f"{tuple(g.shape)}, expected {'.'.join(pw)} "
                f"{tuple(w.shape)}")


def _group_indices(sd: Dict[str, torch.Tensor], root: str) -> List[int]:
    pat = re.compile(rf"^{re.escape(root)}\.(\d+)\.")
    return sorted({int(m.group(1)) for k in sd if (m := pat.match(k))})


def import_irn_state_dict(spec: Sequence[LayerSpec],
                          sd: Dict[str, torch.Tensor],
                          c_in: int = 3) -> List[Optional[Dict]]:
    """Map an ``InvRescaleNet`` state_dict onto the IRN spec's params list.

    The reference's op list is [Haar, (Haar, InvBlockExp x k) per octave],
    the order :func:`build_irn_spec` emits, so ops and spec entries pair
    one to one; each op's kind is read off its keys and the sequence is
    checked against the spec."""
    idxs = _group_indices(sd, "operations")
    if not idxs:
        raise TorchImportError(
            "no 'operations.{i}.*' keys: not an InvRescaleNet state_dict")
    kinds = []
    for i in idxs:
        if f"operations.{i}.haar_weights" in sd:
            kinds.append("haar")
        elif f"operations.{i}.F.conv1.weight" in sd:
            kinds.append("invblock")
        else:
            raise TorchImportError(
                f"operations.{i}: neither HaarDownsampling nor InvBlockExp "
                f"keys found")
    spec_kinds = [layer.kind for layer in spec]
    if kinds != spec_kinds:
        raise TorchImportError(
            f"checkpoint op sequence {kinds} != spec {spec_kinds}: wrong "
            f"--scale/--num_coupling for this checkpoint?")

    shapes = _param_shapes(spec, c_in)
    params: List[Optional[Dict]] = []
    consumed = set()
    c = c_in
    for li, (i, layer) in enumerate(zip(idxs, spec)):
        if layer.kind == "haar":
            hk = f"operations.{i}.haar_weights"
            bank, want = sd[hk], _expected_haar_bank(c)
            if bank.shape != want.shape or not torch.equal(bank, want):
                raise TorchImportError(
                    f"{hk}: fixed Haar bank differs from the reference "
                    f"construction (shape {tuple(bank.shape)}, expected "
                    f"{tuple(want.shape)}): corrupted or incompatible "
                    f"checkpoint")
            consumed.add(hk)
            params.append(None)
            c *= 4
            continue
        p = {}
        for sub in ("F", "G", "H"):
            p[sub] = {}
            for ci in range(1, 6):
                prefix = f"operations.{i}.{sub}.conv{ci}"
                p[sub][f"conv{ci}"] = _conv(sd, prefix)
                consumed.update({f"{prefix}.weight", f"{prefix}.bias"})
        _check_shapes(li, p, shapes[li])
        params.append(p)
    _check_leftovers(sd, consumed)
    return params


def import_srf_state_dict(spec: Sequence[LayerSpec],
                          sd: Dict[str, torch.Tensor],
                          c_in: int = 3) -> List[Optional[Dict]]:
    """Map a FrEIA ``ReversibleGraphNet`` state_dict onto the SRF spec:
    coupling blocks by their ``s1`` / ``s2`` subnet keys, in ascending
    ``module_list`` index order (the order :func:`build_srf_spec` emits
    GLOW layers in)."""
    idxs = _group_indices(sd, "module_list")
    glow_idxs = [i for i in idxs if f"module_list.{i}.s1.0.weight" in sd]
    n_glow = sum(1 for layer in spec if layer.kind == "glow")
    if not glow_idxs:
        raise TorchImportError(
            "no 'module_list.{i}.s1.0.weight' keys: not a FrEIA "
            "UncondSRFlow state_dict (or an unsupported FrEIA version; "
            "expected GLOWCouplingBlock subnets at s1/s2 as "
            "nn.Sequential(conv, relu, conv))")
    if len(glow_idxs) != n_glow:
        raise TorchImportError(
            f"{len(glow_idxs)} coupling blocks in the checkpoint, spec has "
            f"{n_glow}: wrong --scale/--num_coupling for this checkpoint?")

    shapes = _param_shapes(spec, c_in)
    params: List[Optional[Dict]] = []
    consumed = set()
    git = iter(glow_idxs)
    for li, layer in enumerate(spec):
        if layer.kind != "glow":
            params.append(None)
            continue
        i = next(git)
        p = {}
        for sub in ("s1", "s2"):
            p[sub] = {}
            for cname, si in (("conv1", 0), ("conv2", 2)):
                prefix = f"module_list.{i}.{sub}.{si}"
                p[sub][cname] = _conv(sd, prefix)
                consumed.update({f"{prefix}.weight", f"{prefix}.bias"})
        _check_shapes(li, p, shapes[li])
        kh = p["s1"]["conv1"]["w"].shape[2]
        if kh != layer.kernel:
            raise TorchImportError(
                f"layer {li}: checkpoint subnet kernel {kh}x{kh}, spec "
                f"expects {layer.kernel}x{layer.kernel}: the reference "
                f"alternates 3x3/1x1 subnets")
        params.append(p)
    _check_leftovers(sd, consumed)
    return params


def _check_leftovers(sd: Dict[str, torch.Tensor], consumed: set) -> None:
    """Unconsumed '.weight' / '.bias' keys mean the mapping missed trainable
    parameters: refuse rather than drop them. Parameter-free buffers are
    fine."""
    left = [k for k in sd if k not in consumed
            and (k.endswith(".weight") or k.endswith(".bias"))]
    if left:
        raise TorchImportError(
            f"{len(left)} trainable keys not consumed by the import (first "
            f"few: {left[:4]}): unsupported checkpoint layout")


def import_state_dict(spec: Sequence[LayerSpec], ckpt,
                      c_in: int = 3) -> List[Optional[Dict]]:
    """Detect the family (IRN or SRF) and import."""
    sd = flatten_checkpoint(ckpt)
    if any(k.startswith("operations.") for k in sd):
        return import_irn_state_dict(spec, sd, c_in=c_in)
    return import_srf_state_dict(spec, sd, c_in=c_in)


def _check_hyperparams(ckpt, cfg: SRConfig) -> None:
    """Lightning checkpoints carry the reference CLI args
    (``hyper_parameters["opt"]``); when present, the fields that change the
    layer stack must match the config."""
    hp = ckpt.get("hyper_parameters") or ckpt.get("hparams") or {}
    opt = hp.get("opt") if isinstance(hp, dict) else None
    if opt is None:
        return
    for field in ("architecture", "scale", "num_coupling"):
        want = getattr(opt, field, None)
        if want is not None and getattr(cfg, field) != want:
            raise TorchImportError(
                f"checkpoint was trained with {field}={want}, config has "
                f"{field}={getattr(cfg, field)}")


def _torch_load(path: str):
    import pickle

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # Lightning checkpoints pickle the argparse Namespace in
        # hyper_parameters, which weights_only refuses; only those take the
        # full unpickler, any other failure keeps its own diagnostic
        return torch.load(path, map_location="cpu", weights_only=False)


def load_reference_checkpoint(path: str, cfg: SRConfig, c_in: int = 3
                              ) -> Tuple[List[LayerSpec],
                                         List[Optional[Dict]]]:
    """torch.load a reference checkpoint file and import it for ``cfg``."""
    ckpt = _torch_load(path)
    if isinstance(ckpt, dict):
        _check_hyperparams(ckpt, cfg)
    spec, _ = build_inn_spec(cfg, c=c_in)
    return spec, import_state_dict(spec, ckpt, c_in=c_in)


def export_state_dict(spec: Sequence[LayerSpec], params: Sequence,
                      c_in: int = 3) -> Dict[str, torch.Tensor]:
    """INN params -> a reference ``SingleVideoINN`` state_dict (keys
    ``inn.*``, float32 CPU tensors)."""
    cpu = lambda t: t.detach().to("cpu", torch.float32).contiguous()
    sd: Dict[str, torch.Tensor] = {}
    if any(layer.kind == "invblock" for layer in spec):
        c = c_in
        for i, (layer, p) in enumerate(zip(spec, params)):
            if layer.kind == "haar":
                sd[f"inn.operations.{i}.haar_weights"] = _expected_haar_bank(c)
                c *= 4
                continue
            for sub in ("F", "G", "H"):
                for ci in range(1, 6):
                    cv = p[sub][f"conv{ci}"]
                    key = f"inn.operations.{i}.{sub}.conv{ci}"
                    sd[f"{key}.weight"] = cpu(cv["w"])
                    sd[f"{key}.bias"] = cpu(cv["b"])
        return sd
    # SRF: one module_list slot per graph node module in node order, which is
    # the spec order, so the slot index is the spec position. Whether a real
    # FrEIA install numbers its module_list with a constant shift is
    # unverified (the JAX package records the same caveat); the importer
    # sorts whatever coupling indices exist, and renumber_module_list
    # repairs a shifted file.
    for mi, (layer, p) in enumerate(zip(spec, params)):
        if layer.kind != "glow":
            continue
        for sub in ("s1", "s2"):
            for cname, si in (("conv1", 0), ("conv2", 2)):
                cv = p[sub][cname]
                sd[f"inn.module_list.{mi}.{sub}.{si}.weight"] = cpu(cv["w"])
                sd[f"inn.module_list.{mi}.{sub}.{si}.bias"] = cpu(cv["b"])
    return sd


def renumber_module_list(sd: Dict[str, torch.Tensor],
                         offset: int) -> Dict[str, torch.Tensor]:
    """Shift every ``[inn.]module_list.{i}`` index by ``offset``."""
    pat = re.compile(r"^(inn\.)?module_list\.(\d+)\.(.*)$")
    out = {}
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            k = (f"{m.group(1) or ''}module_list.{int(m.group(2)) + offset}."
                 f"{m.group(3)}")
        out[k] = v
    return out


# ===========================================================================
# Flow checkpoints
# ===========================================================================

# spec.encoding -> [(reference buffer name, the port's, trainable?), ...]
_ENC_BUFFERS = {
    "gaussian_ff": [("frequencies", "frequencies", False)],
    "uniform_ff": [("frequencies", "frequencies", False)],
    "rotated_ff": [("frequencies", "frequencies", True),
                   ("magnitudes", "magnitudes", False)],
    "positional": [("freqs", "freqs", False)],
    "rbf": [("centres", "centres", False), ("sigma", "sigma", False)],
    "rbf_grid_random": [("offsets", "offsets", False),
                        ("sigma", "sigma", False)],
    "rbf_grid_uniform": [("offsets", "offsets", False),
                         ("sigma", "sigma", False)],
    "piecewise_gaussian": [("frequencies", "frequencies", False)],
    "piecewise_uniform": [("frequencies", "frequencies", False)],
}


def mask_from_counts(counts, encoding_dim: int) -> torch.Tensor:
    """The reference's ``load_mask``: counts (cells,) -> the soft mask
    (cells, encoding_dim), ones below floor(count) and the count's fraction
    at channel floor(count). float32 on the CPU."""
    counts = torch.as_tensor(counts, dtype=torch.float32).reshape(-1).cpu()
    idx = torch.arange(encoding_dim)[None, :]
    fl = torch.floor(counts)[:, None]
    mask = (idx < fl).to(torch.float32)
    boundary = (idx == fl) & (counts[:, None] < encoding_dim)
    return torch.where(boundary, torch.remainder(counts, 1.0)[:, None], mask)


def _linear(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """A torch ``nn.Linear`` at ``prefix`` -> {'w': (in, out), 'b': (out,)}."""
    wk, bk = f"{prefix}.weight", f"{prefix}.bias"
    for k in (wk, bk):
        if k not in sd:
            raise TorchImportError(f"missing key {k!r}")
    w = sd[wk]
    if w.dim() != 2:
        raise TorchImportError(f"{wk}: expected a 2-D linear weight, got "
                               f"shape {tuple(w.shape)}")
    return {"w": w.t().contiguous(), "b": sd[bk]}


def _like(v: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return v.to(device=want.device, dtype=want.dtype)


def _mlp_prefix(spec, mp: str, j: int, n: int) -> str:
    """The reference key prefix of MLP layer j of n."""
    if spec.kind == "siren":
        # sine layers wrap their linear; the last linear sits bare
        return f"{mp}model.{j}" if j == n - 1 else f"{mp}model.{j}.linear"
    return f"{mp}model.model.{2 * j}"


def import_flow_state_dict(spec, ctrl_cfg, ctrl_state, params, consts, ckpt):
    """Import a reference flow checkpoint onto (params, consts, ctrl_state).

    ``spec``, ``ctrl_cfg`` and the templates come from
    ``train/flow.py`` ``build_flow_model``; every imported tensor is
    shape-checked against its template and lands on its device and dtype.
    Returns the updated (params, consts, ctrl_state); the templates are left
    as they were."""
    from sin_inn_tpu_torch.models import controllers as ctrl

    sd = {(k[len("net."):] if k.startswith("net.") else k): v
          for k, v in flatten_checkpoint(ckpt).items()}
    wrapped = "mask_stashed" in sd
    if wrapped and not spec.is_progressive:
        raise TorchImportError(
            f"checkpoint is controller-wrapped (mask_stashed present) but "
            f"--net {spec.name} is not progressive")
    if spec.is_progressive and not wrapped:
        raise TorchImportError(
            f"--net {spec.name} is progressive but the checkpoint has no "
            f"controller mask — was it trained with a non-progressive net?")
    mp = "model." if wrapped else ""
    consumed = set()
    params = {k: ([dict(layer) for layer in v] if k == "mlp" else dict(v))
              for k, v in params.items()}
    consts = {k: dict(v) for k, v in consts.items()}

    def take(dst, dst_key, src_key):
        if src_key not in sd:
            raise TorchImportError(f"missing key {src_key!r}")
        v, want = sd[src_key], dst[dst_key]
        if tuple(v.shape) != tuple(want.shape):
            raise TorchImportError(
                f"{src_key}: shape {tuple(v.shape)}, expected "
                f"{tuple(want.shape)} — wrong --num-frequencies/"
                f"--hidden-dim/--num-layers for this checkpoint?")
        dst[dst_key] = _like(v, want)
        consumed.add(src_key)

    mlp = params["mlp"]
    for j in range(len(mlp)):
        prefix = _mlp_prefix(spec, mp, j, len(mlp))
        lin = _linear(sd, prefix)
        _check_shapes(j, lin, mlp[j])
        mlp[j] = {k: _like(lin[k], mlp[j][k]) for k in lin}
        consumed.update({f"{prefix}.weight", f"{prefix}.bias"})

    if spec.kind == "encoded":
        for ref_name, ours, trainable in _ENC_BUFFERS[spec.encoding]:
            take(params["enc"] if trainable else consts["enc"], ours,
                 f"{mp}encode.{ref_name}")

    if wrapped:
        mask = mask_from_counts(sd["mask_stashed"], spec.encoding_dim)
        consumed.add("mask_stashed")
        if isinstance(ctrl_state, ctrl.SpatialState):
            if mask.shape[0] != ctrl_cfg.cells:
                raise TorchImportError(
                    f"spatial mask has {mask.shape[0]} cells, config grid "
                    f"has {ctrl_cfg.cells} (res {ctrl_cfg.res}^"
                    f"{ctrl_cfg.mask_dim}) — wrong --spatial-res?")
            repl = {"mask": _like(mask, ctrl_state.mask)}
            for name in ("in_progress", "log_buffer", "log_counter"):
                if name in sd:
                    v, tmpl = sd[name], getattr(ctrl_state, name)
                    if tuple(v.shape) != tuple(tmpl.shape):
                        raise TorchImportError(
                            f"{name}: shape {tuple(v.shape)}, expected "
                            f"{tuple(tmpl.shape)}")
                    repl[name] = _like(v, tmpl)
                    consumed.add(name)
            ctrl_state = ctrl_state._replace(**repl)
        else:
            if mask.shape[0] != 1:
                raise TorchImportError(
                    f"checkpoint mask is spatial ({mask.shape[0]} cells) but "
                    f"--spatially-adaptive is off")
            ctrl_state = ctrl_state._replace(
                mask=_like(mask[0], ctrl_state.mask))

    _check_leftovers(sd, consumed)
    return params, consts, ctrl_state


def load_flow_reference_checkpoint(path: str, spec, ctrl_cfg, ctrl_state,
                                   params, consts):
    """torch.load a reference flow checkpoint and import it onto the
    templates of ``build_flow_model``."""
    return import_flow_state_dict(spec, ctrl_cfg, ctrl_state, params, consts,
                                  _torch_load(path))


def export_flow_state_dict(spec, ctrl_state, params,
                           consts) -> Dict[str, torch.Tensor]:
    """A flow INR (and its controller) -> a reference ``FlowTrainer``
    state_dict (keys ``net.*``, float32 CPU tensors). The controller mask
    leaves as the reference's own stashed counts, ``mask.sum(-1)``."""
    from sin_inn_tpu_torch.models import controllers as ctrl

    cpu = lambda t: t.detach().to("cpu", torch.float32).contiguous()
    sd: Dict[str, torch.Tensor] = {}
    mp = "net.model." if ctrl_state is not None else "net."
    mlp = params["mlp"]
    for j, lin in enumerate(mlp):
        prefix = _mlp_prefix(spec, mp, j, len(mlp))
        sd[f"{prefix}.weight"] = cpu(lin["w"].t())
        sd[f"{prefix}.bias"] = cpu(lin["b"])
    if spec.kind == "encoded":
        for ref_name, ours, trainable in _ENC_BUFFERS[spec.encoding]:
            src = params["enc"] if trainable else consts["enc"]
            sd[f"{mp}encode.{ref_name}"] = cpu(src[ours])
    if ctrl_state is not None:
        sd["net.mask_stashed"] = cpu(ctrl_state.mask).sum(-1).reshape(-1)
        if isinstance(ctrl_state, ctrl.SpatialState):
            for name in ("in_progress", "log_buffer", "log_counter"):
                sd[f"net.{name}"] = cpu(getattr(ctrl_state, name))
    return sd


def save_reference_checkpoint(path: str, sd: Dict[str, torch.Tensor]) -> str:
    """Write a torch-loadable Lightning-style checkpoint file."""
    torch.save({"state_dict": dict(sd)}, path)
    return path
