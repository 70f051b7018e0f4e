"""Learning-rate scheduling: a copy of wekws_tpu/train/scheduler.py.

ReduceLROnPlateau with the reference's training defaults: factor 0.5,
patience 3, min_lr 1e-6, stepped once per epoch on the cv loss.
"""


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        factor: float = 0.5,
        patience: int = 3,
        min_lr: float = 1e-6,
        threshold: float = 1e-4,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
