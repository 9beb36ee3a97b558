from boxfusion_tpu_torch.train.loss import detection_loss, greedy_match
from boxfusion_tpu_torch.train.step import TrainState, make_train_step

__all__ = ["detection_loss", "greedy_match", "TrainState", "make_train_step"]
