"""The offline tools of the port: ``cli.generate_data`` (windowed
{train,val,test}.npz from a generated series or a pandas-layout HDF5 file)
and ``cli.summary`` (each family's parameter table), held against the JAX
package's CLIs and pipeline on the same inputs: the same files, keys,
dtypes and arrays; the same printed lines."""
import os
import sys

import numpy as np
import pytest

from megacrn_tpu.cli import generate_data as jgen
from megacrn_tpu.cli import summary as jsummary
from megacrn_tpu.data import windowing as jwindowing
from megacrn_tpu_torch.cli import generate_data as tgen
from megacrn_tpu_torch.cli import summary as tsummary

from test_torch_megacrnx_harness import write_pandas_fixed


def _assert_same_splits(got_dir, want_dir):
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == [
        "test.npz", "train.npz", "val.npz"]
    for name in os.listdir(want_dir):
        with np.load(os.path.join(want_dir, name)) as w, \
                np.load(os.path.join(got_dir, name)) as g:
            assert sorted(g.files) == sorted(w.files) == [
                "x", "x_offsets", "y", "y_offsets"]
            for k in w.files:
                assert g[k].dtype == w[k].dtype, (name, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=name + k)


@pytest.mark.parametrize("day_in_week", [False, True])
def test_generate_data_synthetic_equals_jax(tmp_path, day_in_week):
    argv = ["--synthetic", "--num_nodes", "8", "--num_steps", "600",
            "--seq_len", "6", "--horizon", "4", "--seed", "3"]
    argv += ["--add_day_in_week"] if day_in_week else []
    jgen.main(argv + ["--output_dir", str(tmp_path / "jax")])
    tgen.main(argv + ["--output_dir", str(tmp_path / "port")])
    _assert_same_splits(tmp_path / "port", tmp_path / "jax")
    with np.load(tmp_path / "port" / "train.npz") as z:
        assert z["x"].shape[1:] == (6, 8, 9 if day_in_week else 2)


def test_generate_data_from_h5_equals_jax_pipeline(tmp_path):
    """The .h5 path on a pandas fixed-layout file written with h5py: the
    port reads it without pandas; the JAX side runs its CLI's pipeline
    (``generate_seq2seq_dataset`` -> ``chronological_split`` ->
    ``save_npz_splits``) on the same values and index (the JAX CLI reads
    the file with ``pandas.read_hdf``, which needs PyTables)."""
    rs = np.random.RandomState(4)
    values = rs.uniform(0, 70, (400, 5))
    values[rs.rand(400, 5) < 0.05] = 0.0
    index = (np.datetime64("2012-03-01") + np.arange(400)
             * np.timedelta64(5, "m"))
    columns = np.array([b"773869", b"767541", b"767542", b"717447",
                        b"717446"])
    path = str(tmp_path / "metr-la.h5")
    write_pandas_fixed(path, values, index, columns)
    tgen.main(["--dataset", "METRLA", "--traffic_df_filename", path,
               "--output_dir", str(tmp_path / "port")])
    x, y = jwindowing.generate_seq2seq_dataset(values, index, 12, 12)
    os.makedirs(tmp_path / "jax")
    jwindowing.save_npz_splits(jwindowing.chronological_split(x, y),
                               str(tmp_path / "jax"), 12, 12)
    _assert_same_splits(tmp_path / "port", tmp_path / "jax")


def test_generate_data_without_h5py_exits_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit, match="h5py"):
        tgen.main(["--traffic_df_filename", str(tmp_path / "x.h5"),
                   "--output_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("argv", [
    ["--model", "MEGACRN"],
    ["--model", "MEGACRNX", "--decoder", "sequence"],
    ["--model", "MEGACRNX", "--memory", "False", "--meta", "False"],
    ["--model", "GTS"],
], ids=["megacrn", "megacrnx_sequence", "megacrnx_plain", "gts"])
def test_summary_prints_the_jax_table(capsys, argv):
    """Line for line the JAX CLI's output: the forward's shape, every
    parameter's JAX name, shape and size in the JAX order, and the
    count."""
    argv = argv + ["--num_variable", "10", "--rnn_units", "8",
                   "--his_len", "4", "--seq_len", "3"]
    jsummary.main(argv)
    want = capsys.readouterr().out.splitlines()
    count = tsummary.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert want[-2:] == [f"In total: {count} trainable parameters. ", ""]
    assert len(want) > 10
