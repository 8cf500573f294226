"""multimodal_learning_tpu_torch — the PyTorch/CUDA port of
``multimodal_learning_tpu`` for one NVIDIA H100.

The JAX package stays beside it as the reference.  The port mirrors its
module layout and names, imports ``torch`` and never ``jax``, and replaces
each Pallas TPU kernel with a CUDA kernel written for Hopper (``sm_90a``),
keeping a plain PyTorch version of each kernel beside it for the CPU and as
the test oracle.

Ported so far (the pofusion teacher's serving path and train step):

- ``config``    the ``Options`` flag surface (own copy)
- ``models``    ResNet18, MaxNet, BilinearFusion, PathomicModel, and the
                weight bridge to and from the JAX package's flax trees
- ``ops``       the Kronecker-fusion kernels: eval forward
                (``csrc/kron_fusion.cu``), its backward (``csrc/kron_bwd.cu``)
                and the masked train forward (``csrc/kron_train.cu``)
- ``data``      on-device augmentation
- ``losses``    NLL, Cox, L1, pred-KD, DistillKL, SP, orth
- ``contrast``  the classic CRD memory bank and NCE loss
- ``train``     the teacher's train and eval steps, Adam and the LR
                schedules, EMA, and the train-state bridge to the JAX package
- ``utils``     fold checkpoints in the JAX package's pickle layout
- ``serve``     the eval forward and its ``torch.save`` artifact
- ``cli``       ``export_model`` and ``predict``
"""

__version__ = "0.2.0"
