"""Input assembly, the rollout, the train and eval steps and the trainers
of the port (the JAX package's ``train``).

The names are loaded at first use: the models import ``train.assemble``,
and the steps import the models, so importing every step here would import
a model module before it is defined.
"""

import importlib

_EXPORTS = {
    **dict.fromkeys(("IMAGENET_MEAN", "IMAGENET_STD", "OUT_MEAN", "OUT_STD",
                     "assemble_model_input", "normalize_image",
                     "denormalize_image", "normalize_model_output"),
                    "assemble"),
    **dict.fromkeys(("TrainState", "make_optimizer", "current_lr",
                     "set_lr"), "state"),
    "make_train_step": "steps",
    "make_eval_step": "steps",
    "make_rollout_fn": "rollout",
    "make_multistep_train_step": "multistep",
    "Trainer": "trainer",
    "ExperimentBase": "experiment",
    "GanTrainState": "gan",
    "make_gan_train_step": "gan",
    "LayoutTrainer": "layout_trainer",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
