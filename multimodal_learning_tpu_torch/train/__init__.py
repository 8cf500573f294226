"""The teacher's and the students' train and eval steps (PyTorch): the
mean teacher (with the masked CLAT stage-1 step), the MICCAI/DSCD
students and the CLAT stage-2 student."""
from .ema import ema_alpha, update_ema
from .optim import ScheduledOptimizer, make_optimizer
from .schedules import make_lr_schedule
from .state import TrainState
from .steps import (build_eval_step, build_teacher_train_step,
                    init_teacher_state)
from .student import (build_student_train_step, freeze_teacher,
                      init_student_state, load_teacher)
from .student_clat import build_clat_student_step, train_clat_student
