"""The benchmark's own tests (``python -m pytest portbench/tests``): CPU
tests of the harness at tiny sizes, and ``cuda``-marked tests that run
a cell on the card and skip without one."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (pint_tpu_torch's CUDA kernels have "
        "no CPU mode); skips where torch.cuda.is_available() is false")


TINY = {"n_pulsars": 4, "total_toas": 1400, "min_toas": 160,
        "max_toas": 600, "cadence_days": 60.0}


def make_copy(dst, tiny=("ng15_binary_dmx",)):
    """A checkout in ``dst`` holding BENCHMARK.json, a copy of
    portbench/ and a link to the port, plus a tiny copy of each
    configuration in ``tiny`` (``tiny_<config>``) with a cell per
    traffic of the real cells, their limits and every per-layer metric
    that lists the real cell."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "pint_tpu_torch"),
               os.path.join(dst, "pint_tpu_torch"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in tiny:
        with open(os.path.join(ROOT, "portbench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        cfg.update(TINY)
        with open(os.path.join(dst, "portbench", "configs",
                               f"tiny_{name}.json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({
            "name": f"tiny_{name}", "source": "tiny", "reduced": [],
            "file": f"portbench/configs/tiny_{name}.json", "why": "tiny"})
        for w in list(bench["workloads"]):
            if w["config"] != name:
                continue
            cell = f"tiny_{w['name']}"
            bench["workloads"].append(dict(w, name=cell,
                                           config=f"tiny_{name}"))
            shutil.copy(os.path.join(ROOT, "portbench", "limits",
                                     f"{w['name']}.json"),
                        os.path.join(dst, "portbench", "limits",
                                     f"{cell}.json"))
            for m in bench["per_layer"] + bench["end_to_end"]:
                if w["name"] in m.get("workloads", ()):
                    m["workloads"].append(cell)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory):
    """One tiny checkout for the session (its TOA schedule is built on
    the first run that needs it and cached inside it)."""
    return make_copy(str(tmp_path_factory.mktemp("portbench")))
