"""The port imports nothing of JAX, nothing of the JAX package, and not
pandas (the machine with the card has numpy and scipy but no pandas)."""
import os
import subprocess
import sys

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
