"""The port's roofline, abstract specs and step counter.

`launch/roofline.py`'s ``model_flops_for`` and ``ideal_decode_bytes`` and
`models/api.py`'s ``abstract_params`` / ``input_specs`` are held exactly
equal to the JAX package's for all 10 architectures × 4 shapes; the
roofline's terms to their closed forms on H100 data-sheet figures; and
`launch/step_analysis.analyze_step` to closed forms: a matmul's FLOPs and
bytes, an L-layer smoke model's count L times one layer's, the flash
kernel counted as one op, and the same counts on the CPU and on meta.
"""
import math

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as RSHAPES
from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import get_config as ref_config
from repro.launch import roofline as RRL
from repro.models import api as RAPI
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attn.kernel import flash_attention_bhsd
from repro_torch.launch import roofline as RL
from repro_torch.launch import step_analysis as SA
from repro_torch.models import api as API
from repro_torch.models import transformer as T

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, pre + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, pre + (str(i),))
    else:
        yield pre, tree


def _same_specs(ref_tree, port_tree):
    ref, port = dict(_flat(ref_tree)), dict(_flat(port_tree))
    assert ref.keys() == port.keys()
    for k, r in ref.items():
        p = port[k]
        assert p.device.type == "meta", k
        assert tuple(p.shape) == tuple(r.shape), k
        assert str(p.dtype) == f"torch.{r.dtype}", k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_equal_the_reference(arch):
    _same_specs(RAPI.abstract_params(ref_config(arch)),
                API.abstract_params(get_config(arch)))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    _same_specs(RAPI.input_specs(ref_config(arch), RSHAPES[shape]),
                API.input_specs(get_config(arch), SHAPES[shape]))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_decode_bytes_equal_the_reference(arch, shape):
    rc, pc = ref_config(arch), get_config(arch)
    assert RL.model_flops_for(pc, SHAPES[shape]) == RRL.model_flops_for(
        rc, RSHAPES[shape])
    if SHAPES[shape].kind == "decode":
        assert RL.ideal_decode_bytes(pc, SHAPES[shape]) == \
            RRL.ideal_decode_bytes(rc, RSHAPES[shape])


def test_roofline_terms_on_h100_figures():
    coll = {c: 0 for c in RL.COLLECTIVES}
    r = RL.Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
                    hlo_flops=989e12 * 256, hlo_bytes=3.35e12 * 256 * 2,
                    coll_bytes=50e9 * 256 * 3, coll_breakdown=coll,
                    model_flops=989e12 * 128, per_device_hbm=1.0)
    assert math.isclose(r.t_compute, 1.0)
    assert math.isclose(r.t_memory, 2.0)
    assert math.isclose(r.t_collective, 3.0)  # past one node: the network
    assert r.bottleneck == "collective"
    assert math.isclose(r.useful_ratio, 0.5)
    assert math.isclose(r.roofline_fraction, 0.5 / 3.0)
    small = RL.Roofline(arch="x", shape="decode_32k", mesh="one", chips=8,
                        hlo_flops=1.0, hlo_bytes=3.35e12 * 8,
                        coll_bytes=450e9 * 8 * 0.5, coll_breakdown=coll,
                        model_flops=0.0, per_device_hbm=1.0,
                        model_bytes=3.35e12 * 8 * 0.25)
    assert math.isclose(small.t_collective, 0.5)  # within a node: NVLink
    assert small.bottleneck == "memory"
    assert math.isclose(small.roofline_fraction, 0.25)
    j = small.to_json()
    assert set(j) >= {"t_compute", "t_memory", "t_collective", "bottleneck",
                      "useful_ratio", "roofline_fraction", "per_device_hbm"}


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (7, 7, True, 0), (5, 9, True, 0), (9, 5, True, 0), (12, 12, True, 4),
    (6, 10, False, 0), (1, 16, True, 0), (33, 33, True, 1)])
def test_flash_work_counts_the_visible_pairs(Sq, Sk, causal, window):
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis = k <= q
        if window:
            vis &= k > q - window
    pairs = int(vis.sum())
    assert RL.flash_pairs(Sq, Sk, causal, window) == pairs
    flops, nbytes = RL.flash_work(2, 4, 2, Sq, Sk, 16, 8, 2, causal, window)
    assert flops == 2 * (16 + 8) * pairs * 2 * 4
    assert nbytes == (2 * 4 * Sq * 24 + 2 * 2 * Sk * 24) * 2


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_count_is_its_closed_form(device, dtype):
    M, K, N = 24, 40, 56
    a = torch.zeros(M, K, dtype=dtype, device=device)
    b = torch.zeros(K, N, dtype=dtype, device=device)
    res = SA.analyze_step(lambda x, y: x @ y, a, b)
    size = a.element_size()
    assert res["flops"] == 2 * M * K * N
    assert res["bytes"] == (M * K + K * N + M * N) * size
    assert res["coll_bytes"] == 0
    assert res["peak_bytes"] == (M * K + K * N + M * N) * size
    res = SA.analyze_step(lambda x: (x * 2).sum(), a)
    # an elementwise op (one a element) and a reduction (its input's)
    assert res["flops"] == 2 * M * K
    assert res["bytes"] == (3 * M * K + 1) * size


def _layer_cfg(n_layers):
    import dataclasses

    return dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                               n_layers=n_layers, attn_impl="pallas_flash")


@pytest.mark.parametrize("L", [2, 4])
def test_l_layers_count_l_times_one_layer(L):
    """The whole forward's count is the embedding and head's plus L times
    one `attn_block_full`'s, flash kernel included."""
    B, S = 2, 16
    toks = torch.zeros((B, S), dtype=torch.int32)

    def run(cfg):
        p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            return SA.analyze_step(lambda t: T.forward(p, cfg, t)[0], toks)

    one, many = run(_layer_cfg(1)), run(_layer_cfg(L))
    cfg = _layer_cfg(1)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(S).expand(B, S)
    with torch.no_grad():
        layer = SA.analyze_step(lambda: T.attn_block_full(
            T.layer(p["layers"], 0), cfg, x, pos))
    for key in ("flops", "bytes"):
        assert many[key] - one[key] == (L - 1) * layer[key], key
    fl = many["kernels"]["flash_attention"]
    assert fl["launches"] == L
    hd = cfg.resolved_head_dim
    want = RL.flash_work(B, cfg.n_heads, cfg.n_kv_heads, S, S, hd, hd, 2,
                         True, 0)
    assert (fl["flops"], fl["bytes"]) == (L * want[0], L * want[1])


def test_flash_counts_as_one_op_on_cpu_and_meta():
    B, H, Hkv, S, D = 2, 4, 2, 24, 16
    counts = []
    for device in ("cpu", "meta"):
        q = torch.zeros((B, H, S, D), device=device)
        k = torch.zeros((B, Hkv, S, D), device=device)
        res = SA.analyze_step(lambda a, b, c: flash_attention_bhsd(
            a, b, c, causal=True, window=5), q, k, k.clone())
        assert res["ops"] == {}  # the plain version's ops are not counted
        assert res["kernels"]["flash_attention"]["launches"] == 1
        assert tuple(res["out"].shape) == (B, H, S, D)
        counts.append((res["flops"], res["bytes"]))
    assert counts[0] == counts[1] == RL.flash_work(B, H, Hkv, S, S, D, D, 4,
                                                   True, 5)


def test_flash_on_meta_keeps_the_cards_limits():
    q = torch.zeros((1, 2, 8, 12), device="meta")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bhsd(q, q, q)


def test_train_step_counts_equal_on_cpu_and_meta():
    """The same train step, on the CPU's tensors and on meta: FLOPs, bytes
    and ops equal (the backward and the remat recompute included)."""
    from repro_torch.train import train_step as TS

    cfg = get_config("qwen2.5-3b", smoke=True)
    shape = ShapeConfig("t", 16, 2, "train")
    out = []
    for device in ("cpu", "meta"):
        p = API.abstract_params(cfg, device)
        if device == "cpu":
            p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        state = TS.init_state(p)
        batch = API.input_specs(cfg, shape, device)
        if device == "cpu":
            batch = {k: torch.zeros_like(v) for k, v in batch.items()}
        step = TS.build_train_step(TS.TrainPlan(cfg=cfg))
        out.append(SA.analyze_step(step, state, batch))
    cpu, meta = out
    assert cpu["ops"] == meta["ops"]
    assert (cpu["flops"], cpu["bytes"]) == (meta["flops"], meta["bytes"])
    assert any(op.startswith("aten.mm") for op in cpu["ops"])
