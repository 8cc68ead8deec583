"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The files the harness reads for it, all found by name, so that a
later cell, configuration, traffic mix or metric is new files and new
entries and never an edit:

  * the configuration: the ``file`` of its ``configs`` entry (JSON), and
    its plain reference ``configs/<reference>.py`` beside it;
  * the traffic mix: ``traffic/<traffic>.json``;
  * the limits of the check that decides ``correct``:
    ``checks/<workload>.json``;
  * each metric, end-to-end or per layer: a reader ``metrics/<name>.py``
    with a function ``read(run)``, which returns the metric's value or
    None when the run has nothing for it to read.

The keys of a configuration's file that the harness reads: ``name``;
``dim``, ``degree`` and ``refinements`` (the mesh and the elements, from
which the traffic builds its right-hand sides and the roofline counts its
work); ``components``, optional, 1 by default: the unknowns a mesh point,
so that a right-hand side has the shape (components,) + grid where it is
more than 1 (linear elasticity's displacements); ``reference``, the name of
the plain reference beside it; ``models``, for each CG dtype the program's
model ``class`` (a name of the package, or a dotted name under it, as
``parallel.ShardedGeometricPoisson``) and its ``kwargs``.  The plain
reference may read further keys of its own (an elasticity reference its
Lame parameters).

A cell's ``chips`` S: with S = 1 the model is built with ``device=`` on
the one card and holds whole fields.  With S > 1 the model holds its state
on cards 0..S-1 (on the CPU S times the CPU; tests may pass a list of S
devices), in S slabs along grid axis 0 of a scalar field (no
``components``).  The harness then builds the class with ``devices=``,
drives ``cg(model.fine_operator.apply, b, model.preconditioner().apply,
rtol, max_iter, dot=model.dot)`` with b the program's sharded field of the
stream's slabs, counts the fine DoFs from the configuration's grid, takes
CG's dtype from ``model.dtype``, and keeps each sampled solution as its
slabs.  The slab layout is the harness's own (``slabs.py``: slab s holds
grid planes [s L, (s + 1) L], L = (N - 1) / S, so neighbours share one
plane); a model whose fine-level slabs differ from it fails in set-up.
The plain reference then gives ``make_blocked`` beside ``make``, the same
operator and solve a block of planes at a time (``check.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

FOLDER = "benchmark"  # the benchmark's folder in the checkout


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list  # entries of BENCHMARK.json's end_to_end for the cell
    per_layer: list  # likewise of per_layer
    root: Path

    def reference(self):
        """The configuration's plain reference module."""
        name = self.config["reference"]
        return load_module(self.root / FOLDER / "configs" / f"{name}.py",
                           f"reference_{name}")

    def reader(self, metric: str):
        """The ``read`` function of ``metric``."""
        return load_module(self.root / FOLDER / "metrics" / f"{metric}.py",
                           f"metric_{metric.replace('.', '_')}").read

    def model_spec(self) -> dict:
        """The program's model that runs this cell: the configuration's
        entry for the traffic's CG dtype."""
        dtype = self.traffic["cg_dtype"]
        try:
            return self.config["models"][dtype]
        except KeyError:
            raise ValueError(f"configuration {self.config['name']} has no "
                             f"model for CG in {dtype}") from None


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    here = root / FOLDER
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    checks = json.loads((here / "checks" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, checks, e2e,
                layer, root)

