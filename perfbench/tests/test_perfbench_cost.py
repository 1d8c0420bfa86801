"""The FLOP counts against the per-launch figures of the port's record, and
the step counts that ``mfu`` uses against the reference's operations
counted by ``torch.utils.flop_counter``."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import cost
from harness import core
from harness.tiny import TINY_CONFIG
from harness.weights import inr_weights, srf_weights
from reference import flow as RF
from reference import srf as RS


def _config(name):
    with open(core.BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_kernel_counts_match_the_record():
    """K1 at batch 8 8.30 G, K3 23.53 G, K7 backward 587.0 G, K7 forward
    (RBF, constant mask) 235.0 G a launch."""
    srf, fl = _config("srf-4x"), _config("flow-rbf-sintel")
    launches = cost.srf_1x1_launches(srf, 8)
    assert launches == [(112640, 48), (112640, 48), (28160, 192),
                        (28160, 192)]
    assert cost.coupling_cost(112640, 48, 256)[0] / 1e9 == pytest.approx(
        8.30, abs=0.005)
    assert cost.coupling_cost(28160, 192, 256)[0] / 1e9 == pytest.approx(
        8.30, abs=0.005)
    assert cost.backward_cost(112640, 48, 256)[0] / 1e9 == pytest.approx(
        23.53, abs=0.005)
    assert cost.backward_cost(112640, 48, 256, inverse=True)[0] / 1e9 == \
        pytest.approx(24.91, abs=0.005)
    n = 436 * 1024
    w = cost.inr_widths(fl)
    assert w == [512, 256, 256, 256, 4]
    assert cost.inr_backward_cost(n, w)[0] / 1e9 == pytest.approx(587.0,
                                                                  abs=0.05)
    assert cost.inr_forward_cost(n, w)[0] / 1e9 == pytest.approx(235.0,
                                                                 abs=0.05)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_srf_step_flops_count_the_reference():
    cfg = dict(_config("srf-4x"), **TINY_CONFIG["srf-4x"])
    b = 2
    _, p = srf_weights(cfg, 1, "cpu")
    hr = torch.randint(0, 255, (b, cfg["hr_height"], cfg["hr_width"], 3),
                       dtype=torch.uint8)
    x = hr.float() / 255
    with torch.no_grad():
        fwd = _counted(lambda: RS.srf(p, cfg, x))
        y = RS.srf(p, cfg, x)
        inv = _counted(lambda: RS.srf(p, cfg, y, rev=True))
    assert fwd == inv == cost.srf_pass_flops(cfg, b)
    lr_dims = (2 * cfg["lr_window"] + 1) * 4
    lr = torch.randint(0, 255, y[..., :lr_dims].shape, dtype=torch.uint8)
    z = torch.randn(y[..., lr_dims:].shape)
    for t in p.values():
        t.requires_grad_(True)
    step = _counted(lambda: RS.sr_loss(p, cfg, hr, lr, z).backward())
    # the backward needs no gradient of the input of the first coupling's
    # first convolution (the HR frame): slightly under twice the passes
    assert 0.95 * cost.srf_step_flops(cfg, b) <= step <= \
        cost.srf_step_flops(cfg, b)


def test_flow_flops_count_the_reference():
    cfg = dict(_config("flow-rbf-sintel"), **TINY_CONFIG["flow-rbf-sintel"])
    h, w = cfg["height"], cfg["width"]
    _, _, p = inr_weights(cfg, 1, "cpu")
    times = torch.tensor([-0.5, 0.25])
    with torch.no_grad():
        mm = _counted(lambda: RF.query(p, times, h, w, w / 5.0))
    n = 2 * h * w
    assert mm == cost.inr_forward_cost(n, cost.inr_widths(cfg))[0]
    assert cost.flow_query_flops(cfg, 2, h, w) == mm + \
        cost.rbf_encoding_flops(n, cfg)
    for k in p:
        if k.startswith("mlp"):
            p[k].requires_grad_(True)
    f12, f21 = RF.query(p, times, h, w, w / 5.0)
    back = _counted(lambda: (f12.sum() + f21.sum()).backward())
    # the first layer's input needs no gradient: the backward counts the
    # weight gradients of every layer and the chain through all but one
    assert back <= 2 * mm
    assert cost.flow_train_step_flops(cfg, 2, h, w) == \
        cost.flow_query_flops(cfg, 2, h, w) + 2 * mm
