from repro_torch.train.trainer import Trainer, make_train_step  # noqa: F401
