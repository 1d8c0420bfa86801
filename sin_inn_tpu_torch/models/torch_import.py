"""Import and export reference (torch / PyTorch-Lightning) SR checkpoints.

Counterpart of the SR half of ``sin_inn_tpu/models/torch_import.py``. The
reference trains ``SingleVideoINN`` Lightning modules that hold the network
at ``self.inn``; this module maps such a ``state_dict`` onto the params list
of the matching :func:`sin_inn_tpu_torch.models.inn.build_inn_spec` spec
(``sr test --import-torch ckpt`` renders with reference-trained weights,
``sr train --import-torch`` fine-tunes from them), and writes a params list
back out in the same schema (``sr export``). Two families:

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
(``train/loop.py``): the import seeds a run, resume continues one. The flow
checkpoints' half of the reference module is not ported.
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


def save_reference_checkpoint(path: str, sd: Dict[str, torch.Tensor]) -> str:
    """Write a torch-loadable Lightning-style checkpoint file."""
    torch.save({"state_dict": dict(sd)}, path)
    return path
