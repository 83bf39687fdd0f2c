from . import optimizer, train_step  # noqa
