"""The five `examples/torch_*.py` scripts on the CPU, against the
reference's `examples/*.py` run in this process under jax on the CPU.

The graph scripts print what the reference's print, timings aside; the
MoE script's router, fed the reference example's parameters through
`interop`, picks the reference's experts exactly, and the co-activation
graph and its summary are equal; the LM scripts run to completion. The
card's run is `tests/test_torch_cuda.py::test_cuda_quickstart_example`.
"""
import importlib.util
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core import summarize

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    return CS


# the one loader of `examples/torch_<name>.py` and the one reading of what
# an example printed, `chip_smoke.py`'s, which its `examples` phase uses
CS = _chip_smoke()
load_example, _printed = CS.load_example, CS.printed_lines


def _reference(name: str, capsys) -> tuple:
    """Run the reference's ``examples/<name>.py`` here; its stdout and
    its globals."""
    capsys.readouterr()
    env = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out, env


@pytest.mark.parametrize("name", ["quickstart", "summarize_and_query"])
def test_graph_example_prints_what_the_reference_prints(name, capsys):
    want, _ = _reference(name, capsys)
    load_example(name).main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _printed(got) == _printed(want)
    assert len(_printed(got)) >= 4


def test_moe_router_and_graph_equal_the_reference(capsys):
    import jax

    _, ref = _reference("moe_routing_graph", capsys)
    ex = load_example("moe_routing_graph")
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = interop.params_from_arrays(
        cfg, jax.tree.map(np.asarray, ref["params"]), device="cpu")
    toks = torch.from_numpy(np.array(ref["toks"]))
    with torch.no_grad():
        top_e = ex.router_top_experts(params, cfg, toks)
    assert top_e.shape == ref["top_e"].shape == (8 * 64, cfg.moe.top_k)
    np.testing.assert_array_equal(top_e, ref["top_e"])
    g = ex.coactivation_graph(top_e, cfg.moe.n_experts)
    assert (g.n, g.m) == (ref["g"].n, ref["g"].m)
    np.testing.assert_array_equal(g.indptr, ref["g"].indptr)
    np.testing.assert_array_equal(g.indices, ref["g"].indices)
    s = summarize(g, T=10, seed=0, device="cpu")
    np.testing.assert_array_equal(s.parent, ref["s"].parent)
    np.testing.assert_array_equal(s.edges, ref["s"].edges)
    assert s.validate_lossless(g)


def test_moe_example_runs_on_its_own_weights(capsys):
    top_e, g, s = load_example("moe_routing_graph").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "lossless=True" in out and s.validate_lossless(g)
    assert top_e.shape == (8 * 64, 2) and g.n == 4


def test_serve_example_runs_to_completion(capsys):
    outs = load_example("serve_lm").main(["--device", "cpu"])
    assert len(outs) == 6 and all(len(o) == 12 for o in outs)
    assert "[serve] 6 requests × 12 tokens" in capsys.readouterr().out


def test_train_example_lowers_the_loss(capsys):
    """80 steps: the reference's schedule warms the learning rate up over
    100 steps, so at 20 it is still below 6e-5 and the loss has not moved
    from step 0's (5.543 → 5.553 on the CPU)."""
    losses = load_example("train_lm").main(["--device", "cpu", "--steps",
                                            "80"])
    assert len(losses) == 80 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "OK: loss" in capsys.readouterr().out
