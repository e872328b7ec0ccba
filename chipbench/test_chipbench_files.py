"""`BENCHMARK.json` and the files it names: every cell's configuration,
traffic, limits and metric readers exist and are found by name; nothing
under ``chipbench/`` imports JAX or the JAX package, and the references
import nothing of the port."""
import ast
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_and_no_jax_package():
    for path in HERE.rglob("*.py"):
        bad = imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (path, bad)


def test_references_import_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        assert not imports(path) & {"repro_torch", "repro", "jax",
                                    "chipbench"}, path


def test_every_cell_finds_its_files():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        c = json.loads((HERE.parent / configs[w["config"]]["file"])
                       .read_text())
        assert (HERE / "reference" / f"{c['bench']['reference']}.py").exists()
        assert (HERE / "adapters" / f"{c['bench']['reference']}.py").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v >= 0 for v in limits.values())
        mine = [m for m in metrics if w["name"] in m.get("workloads",
                                                         [w["name"]])]
        assert any(m["name"] == "setup_s" for m in mine)
        assert len([m for m in mine if m in BENCH["end_to_end"]]) >= 2
        assert any(m in BENCH["per_layer"] for m in mine)
    for m in metrics:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
