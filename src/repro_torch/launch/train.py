"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet \
        --smoke --steps 20 --device cpu [--compress int8]
    PYTHONPATH=src python -m repro_torch.launch.train --arch dien \
        --smoke --steps 20 --device cpu

Drives the fault-tolerant loop (checkpoint and resume, the straggler
monitor, optional gradient compression) on ``--device`` (default: the CUDA
card; on a host without one pass ``--device cpu``). Data is the synthetic
pipeline, the reference's batches as tensors on the device: for a GNN,
blocks sampled by ``NeighborSampler`` (fanouts 6 and 4) from a 32 x 32
mesh graph; for a recsys arch (``bst``, ``dien``, ``deepfm``,
``wide-deep``), ``--batch`` rows of dense features, uniform sparse ids,
0/1 labels and, for DIEN and BST, behavior sequences and target items. The
LM family waits for its slice of the port.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def data_iterator(cfg, batch: int, seq: int, seed: int = 0,
                  device: str | torch.device | None = None):
    """Batches of ``cfg``'s family on ``device`` (the CUDA card by
    default); the numpy draws are the reference's, so the same seed gives
    the same batches."""
    from repro_torch.common.device import resolve_device
    from repro_torch.config.base import GNNConfig, RecsysConfig
    if isinstance(cfg, GNNConfig):
        device = resolve_device(device)
        from repro_torch.data.graph_sampler import (NeighborSampler,
                                                    random_mesh_graph)
        rng = np.random.default_rng(seed)
        csr, feats = random_mesh_graph(1024, cfg.in_node_dim, seed)
        targets = rng.normal(size=(feats.shape[0], cfg.out_dim)
                             ).astype(np.float32)
        sampler = NeighborSampler(csr, fanouts=(6, 4), seed=seed)
        while True:
            seeds = rng.integers(0, feats.shape[0], size=batch)
            b = sampler.block_batch(seeds, feats, targets,
                                    d_edge=cfg.in_edge_dim)
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    if isinstance(cfg, RecsysConfig):
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        hot = max(cfg.multi_hot_sizes) if cfg.multi_hot_sizes else 1
        while True:
            b = {"dense": rng.normal(size=(batch, cfg.n_dense)
                                     ).astype(np.float32),
                 "sparse": np.stack(
                     [rng.integers(0, cfg.field_vocabs[f], size=(batch, hot))
                      for f in range(cfg.n_sparse)], axis=1
                     ).astype(np.int32),
                 "labels": rng.integers(0, 2, size=batch
                                        ).astype(np.float32)}
            if cfg.seq_len:
                b["seq"] = rng.integers(0, cfg.item_vocab,
                                        size=(batch, cfg.seq_len)
                                        ).astype(np.int32)
                b["target_item"] = rng.integers(0, cfg.item_vocab,
                                                size=batch).astype(np.int32)
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    raise NotImplementedError(
        f"training {type(cfg).__name__} waits for the LM slice of the port "
        f"(transformer.py, LMConfig)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on")
    args = ap.parse_args(argv)

    from repro_torch.common.device import resolve_device
    from repro_torch.config.base import get_arch
    from repro_torch.training.loop import LoopConfig, train

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.smoke_config if args.smoke else arch.config
    lc = LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                    checkpoint_dir=args.ckpt_dir, lr=args.lr,
                    grad_compression=args.compress)
    st = train(cfg, data_iterator(cfg, args.batch, args.seq, device=dev), lc,
               device=dev, verbose=True)
    losses = [m["loss"] for m in st.metrics_history]
    print(f"done: {st.step} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"stragglers={len(st.straggler_steps)}")


if __name__ == "__main__":
    main()
