"""Trainers: the Liquid-Warping-GAN training / personalization step.

Twin of `ipercore_tpu/trainers/__init__.py`: the registry maps `opt.train_name`
to whether the aug-bg branch is on and which generator family the trainer
trains.
"""
from ipercore_tpu_torch.trainers.lwg_trainer import (  # noqa: F401
    LWGTrainState,
    TrainConfig,
    create_train_state,
    train_step,
)

TRAINER_REGISTRY = {
    "LWGTrainer": dict(aug_bg=False, default_gen="AttLWB-SPADE"),
    "LWGAugBGTrainer": dict(aug_bg=True, default_gen="AttLWB-SPADE"),
    "LWGFrontTrainer": dict(aug_bg=False, default_gen="AttLWB-Front"),
    "BaselineTrainer": dict(aug_bg=False, default_gen="InputConcat"),
}


def resolve_trainer(name: str) -> dict:
    """The trainer spec of `opt.train_name` (a copy)."""
    if name not in TRAINER_REGISTRY:
        raise KeyError(f"unknown trainer {name!r}; have {sorted(TRAINER_REGISTRY)}")
    return dict(TRAINER_REGISTRY[name])
