"""Architecture smoke entry: build the model, run one forward on a random
batch, print the trainable-parameter table (counterpart of
``megacrn_tpu/cli/summary.py``; the reference's ``python MegaCRN.py``,
``model/MegaCRN.py:207-226``).

    python -m megacrn_tpu_torch.cli.summary --num_variable 207 --rnn_units 64
    python -m megacrn_tpu_torch.cli.summary --model MEGACRNX --decoder sequence
    python -m megacrn_tpu_torch.cli.summary --model GTS --device cpu

The flags are the JAX CLI's, and ``--device`` (the card unless it says
otherwise). The table lists the JAX package's parameter names (its flat
naming, ``interop``), in its order, with the same shapes and count, so the
two packages print the same lines.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def _jax_order(flat: Dict[str, np.ndarray]):
    """(dotted name, array) of flat ``a/b/0/c`` params in the order JAX
    flattens the nested tree: dict keys sorted, list items by index (a
    level whose keys are all digits is a list)."""
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = a

    def walk(node, prefix):
        if not isinstance(node, dict):
            yield ".".join(prefix), node
            return
        keys = (sorted(node, key=int) if all(k.isdigit() for k in node)
                else sorted(node))
        for k in keys:
            yield from walk(node[k], prefix + [k])

    return list(walk(tree, []))


def print_params_table(flat: Dict[str, np.ndarray]) -> int:
    """print_params parity (model/MegaCRN.py:196-205): name, shape, numel,
    of the params in the JAX package's flat naming; returns the count."""
    count = 0
    print("Trainable parameter list:")
    for name, a in _jax_order(flat):
        print(name, tuple(a.shape), a.size)
        count += int(a.size)
    print(f"In total: {count} trainable parameters. \n")
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", type=str, default="MEGACRN",
                   choices=["MEGACRN", "MEGACRNX", "GTS"])
    p.add_argument("--num_variable", type=int, default=207)
    p.add_argument("--his_len", type=int, default=12)
    p.add_argument("--seq_len", type=int, default=12)
    p.add_argument("--channelin", type=int, default=1)
    p.add_argument("--channelout", type=int, default=1)
    p.add_argument("--rnn_units", type=int, default=64)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--memory", type=lambda s: s == "True", default=True)
    p.add_argument("--meta", type=lambda s: s == "True", default=True)
    p.add_argument("--decoder", type=str, default="stepwise",
                   choices=["sequence", "stepwise"])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the card; with no card the run stops) or "
                        "'cpu'")
    args = p.parse_args(argv)

    import torch

    from megacrn_tpu_torch import resolve_device
    from megacrn_tpu_torch import interop

    device = resolve_device(args.device)
    x = np.random.randn(args.batch, args.his_len, args.num_variable,
                        args.channelin).astype(np.float32)
    ycov = np.random.randn(args.batch, args.seq_len, args.num_variable,
                           1).astype(np.float32)
    x, ycov = (torch.from_numpy(a).to(device) for a in (x, ycov))

    with torch.no_grad():
        if args.model == "MEGACRN":
            from megacrn_tpu_torch.config import MegaCRNConfig
            from megacrn_tpu_torch.models.megacrn import MegaCRN

            cfg = MegaCRNConfig(num_nodes=args.num_variable,
                                input_dim=args.channelin,
                                output_dim=args.channelout,
                                horizon=args.seq_len, seq_len=args.his_len,
                                rnn_units=args.rnn_units)
            model = MegaCRN(cfg, device=device)
            out = model(x, ycov).output
            flat = interop.flat_from_state_dict(model.state_dict(),
                                                cfg.num_layers)
        elif args.model == "MEGACRNX":
            from megacrn_tpu_torch.models.megacrnx import (MegaCRNx,
                                                           MegaCRNxConfig)

            cfg = MegaCRNxConfig(
                num_nodes=args.num_variable, input_dim=args.channelin,
                output_dim=args.channelout, horizon=args.seq_len,
                seq_len=args.his_len, rnn_units=args.rnn_units,
                memory_type=args.memory, meta_type=args.meta,
                decoder_type=args.decoder)
            model = MegaCRNx(cfg, device=device)
            out = model(x, ycov).output
            flat = interop.flat_from_megacrnx_state_dict(model.state_dict(),
                                                         cfg.num_layers)
        else:
            from megacrn_tpu_torch.config import GTSConfig
            from megacrn_tpu_torch.models.gts import GTS

            cfg = GTSConfig(num_nodes=args.num_variable,
                            input_dim=args.channelin,
                            output_dim=args.channelout, horizon=args.seq_len,
                            seq_len=args.his_len, rnn_units=args.rnn_units,
                            train_series_len=100)
            model = GTS(cfg, device=device)
            feas = torch.from_numpy(np.random.randn(
                100, args.num_variable).astype(np.float32)).to(device)
            out = model(x, feas, generator=torch.Generator(
                device=device).manual_seed(0)).output
            flat, _ = interop.flat_from_gts_state_dict(model.state_dict(),
                                                       cfg)

    print(f"forward output shape: {tuple(out.shape)}")
    return print_params_table(flat)


if __name__ == "__main__":
    main()
