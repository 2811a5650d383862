from thermal3d_torch.train.loop import train_and_evaluate
from thermal3d_torch.train.state import create_train_state, make_lr_schedule
from thermal3d_torch.train.step import make_eval_step, make_train_step
