"""The port imports nothing of JAX, nothing of the JAX package, and not
pandas (the machine with the card has numpy and scipy but no pandas); its
kernels import nothing above them, and only ``ops.graph``'s table tests
a graph constant's type."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import megacrn_tpu_torch
names = ["megacrn_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(megacrn_tpu_torch.__path__,
                                          "megacrn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "megacrn_tpu" or m.startswith("megacrn_tpu.")
             or m == "pandas" or m.startswith("pandas."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_no_jax_package_and_no_pandas():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("megacrn_tpu_torch.serve", "megacrn_tpu_torch.kernels._build",
                "megacrn_tpu_torch.kernels.spmm_coo",
                "megacrn_tpu_torch.kernels.spmm",
                "megacrn_tpu_torch.models.megacrn",
                "megacrn_tpu_torch.ops.losses",
                "megacrn_tpu_torch.train.optim",
                "megacrn_tpu_torch.train.steps",
                # the harness slice
                "megacrn_tpu_torch.config",
                "megacrn_tpu_torch.data.scalers",
                "megacrn_tpu_torch.data.synthetic",
                "megacrn_tpu_torch.data.windowing",
                "megacrn_tpu_torch.data.loader",
                "megacrn_tpu_torch.data.expytky",
                "megacrn_tpu_torch.data.datasets",
                "megacrn_tpu_torch.ops.metrics",
                "megacrn_tpu_torch.nn.init",
                "megacrn_tpu_torch.train.checkpoint",
                "megacrn_tpu_torch.train.logs",
                "megacrn_tpu_torch.train.telemetry",
                "megacrn_tpu_torch.train.eval_modes",
                "megacrn_tpu_torch.train.loop",
                "megacrn_tpu_torch.cli.traintest",
                # the graph backends slice
                "megacrn_tpu_torch.kernels.spmm_ell_node",
                "megacrn_tpu_torch.kernels.sparse_graph_node",
                "megacrn_tpu_torch.kernels.sparse_graph",
                # the two other model families: MegaCRNx and GTS
                "megacrn_tpu_torch.data.hdf5",
                "megacrn_tpu_torch.data.graph_prior",
                "megacrn_tpu_torch.nn.norm",
                "megacrn_tpu_torch.nn.dcgru",
                "megacrn_tpu_torch.models.megacrnx",
                "megacrn_tpu_torch.models.gts",
                "megacrn_tpu_torch.interop",
                "megacrn_tpu_torch.train.megacrnx_loop",
                "megacrn_tpu_torch.train.gts_loop",
                "megacrn_tpu_torch.cli.traintest_megacrnx",
                "megacrn_tpu_torch.cli.traintest_gts",
                # the mesh
                "megacrn_tpu_torch.parallel.comm",
                "megacrn_tpu_torch.parallel.mesh",
                "megacrn_tpu_torch.parallel.multihost",
                "megacrn_tpu_torch.parallel.launch",
                "megacrn_tpu_torch.parallel.ring",
                "megacrn_tpu_torch.parallel.api",
                # the last slice: the offline tools, debug, prefetch, the
                # host library
                "megacrn_tpu_torch.cli.generate_data",
                "megacrn_tpu_torch.cli.summary",
                "megacrn_tpu_torch.train.debug",
                "megacrn_tpu_torch.train.prefetch",
                "megacrn_tpu_torch.data.native"):
        assert mod in res["modules"]


def test_spawned_ranks_import_no_jax(tmp_path):
    """A rank that ``parallel.launch`` spawns from this process (which has
    JAX loaded) starts afresh: neither JAX nor the JAX package reaches
    it."""
    import json

    import jax  # noqa: F401  (loaded in the parent on purpose)

    import torch_mesh_ranks
    from megacrn_tpu_torch.parallel import launch

    launch.spawn(torch_mesh_ranks.record_imports, 2, args=(str(tmp_path),),
                 coordinator=f"file://{tmp_path / 'rendezvous'}",
                 device="cpu")
    for r in (0, 1):
        with open(tmp_path / f"imports{r}.json") as f:
            assert json.load(f) == []


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names neither JAX nor the JAX package in its imports."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "megacrn_tpu"}, sorted(names)


PORT = os.path.join(ROOT, "megacrn_tpu_torch")


def _sources(*parts):
    """(path, ast) of each module at ``parts`` under the port: a file or
    every file of a directory."""
    path = os.path.join(PORT, *parts)
    files = ([path] if path.endswith(".py") else sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".py")))
    for f in files:
        with open(f) as fh:
            yield os.path.relpath(f, ROOT), ast.parse(fh.read())


def _upward_imports():
    """Imports from a kernel module of the packages above the kernels, at
    the top of the module or inside a function; a relative import is
    resolved against ``megacrn_tpu_torch.kernels``."""
    above = {"ops", "parallel", "models", "train", "serve"}
    bad = []
    for path, tree in _sources("kernels"):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = ["megacrn_tpu_torch", "kernels"][:max(
                    0, 3 - node.level)] if node.level else []
                module = ".".join(base + ([node.module] if node.module
                                          else []))
                names = [f"{module}.{a.name}" for a in node.names]
            else:
                continue
            bad += [(path, node.lineno, n) for n in names
                    if n.split(".")[:1] == ["megacrn_tpu_torch"]
                    and n.split(".")[1:2] in [[a] for a in above]]
    return bad


def _constant_type_tests():
    """``isinstance`` tests naming a graph-constant type (a NamedTuple
    that a kernel module defines), directly or through a module-level
    name, outside ``ops/graph.py``'s table and the kernel modules."""
    types = {node.name for _, tree in _sources("kernels")
             for node in ast.walk(tree) if isinstance(node, ast.ClassDef)
             and any(getattr(b, "id", None) == "NamedTuple"
                     for b in node.bases)}
    bad = []
    for parts in (("models",), ("train",), ("cli",), ("serve.py",),
                  ("parallel", "api.py")):
        for path, tree in _sources(*parts):
            aliases = {t.id: node.value for node in tree.body
                       if isinstance(node, ast.Assign)
                       for t in node.targets if isinstance(t, ast.Name)}

            def named(expr, seen=()):
                out = set()
                for n in ast.walk(expr):
                    name = (n.id if isinstance(n, ast.Name) else n.attr
                            if isinstance(n, ast.Attribute) else None)
                    if name in types:
                        out.add(name)
                    elif name in aliases and name not in seen:
                        out |= named(aliases[name], seen + (name,))
                return out

            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "id", None) == "isinstance"
                        and len(node.args) == 2):
                    bad += [(path, node.lineno, t)
                            for t in sorted(named(node.args[1]))]
    return bad, types


@pytest.mark.parametrize("rule", ["kernels_import_nothing_above",
                                  "no_type_tests_of_graph_constants"])
def test_graph_constants_have_one_seam(rule):
    """The layering around the graph constants, read from the sources: no
    kernel module imports ``ops``, ``parallel``, ``models``, ``train`` or
    ``serve``; and the model, the train loops, the CLIs, the predictors
    and the mesh steps name no graph-constant type in an ``isinstance``
    test, since ``ops.graph``'s table answers for each type."""
    if rule == "kernels_import_nothing_above":
        assert _upward_imports() == []
    else:
        bad, types = _constant_type_tests()
        assert {"StackedRoadPack", "BlockELL", "LocalNodePattern",
                "ShardedRoadPacks"} <= types
        assert bad == []
