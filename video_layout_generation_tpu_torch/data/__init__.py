"""Datasets and loaders of the port (the JAX package's ``data``)."""

from .cityscapes import CityscapesSequences, CityscapesTriplets
from .index import build_triplet_index
from .pipeline import DeviceLoader, HostLoader
from .synthetic import SyntheticTriplets


def get_dataset(cfg):
    """(train_dataset, val_dataset) for the configured dataset.

    With ``multistep_k > 1`` the train dataset carries K+2-frame windows
    (``train/multistep.py``), with ``scheduled_sampling`` at least 4
    (``train/scheduled.py``); validation stays on triplets, so that its
    metrics compare across K."""
    k = getattr(cfg, "multistep_k", 1)
    train_frames = k + 2 if k > 1 else 3
    if getattr(cfg, "scheduled_sampling", 0.0) > 0:
        train_frames = max(train_frames, 4)
    if cfg.dataset == "cityscape":
        if train_frames != 3:
            train = CityscapesSequences(cfg.train_dir, train_frames,
                                        cfg.image_size)
        else:
            train = CityscapesTriplets(cfg.train_dir, cfg.image_size)
        return train, CityscapesTriplets(cfg.val_dir, cfg.image_size)
    if cfg.dataset == "synthetic":
        # emit the uint8 encoding directly when the pipeline ships uint8
        u8 = getattr(cfg, "transfer_uint8", False) and cfg.n_classes <= 255
        return (SyntheticTriplets(cfg.synthetic_train_size, cfg.image_size,
                                  cfg.n_classes, seed=cfg.seed,
                                  emit_uint8=u8, n_frames=train_frames),
                SyntheticTriplets(cfg.synthetic_val_size, cfg.image_size,
                                  cfg.n_classes, seed=cfg.seed + 1,
                                  emit_uint8=u8))
    raise ValueError(f"Invalid dataset {cfg.dataset!r}")


__all__ = ["build_triplet_index", "SyntheticTriplets", "CityscapesTriplets",
           "CityscapesSequences", "HostLoader", "DeviceLoader",
           "get_dataset"]
