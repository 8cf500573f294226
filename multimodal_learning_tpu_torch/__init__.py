"""multimodal_learning_tpu_torch — the PyTorch/CUDA port of
``multimodal_learning_tpu`` for one NVIDIA H100.

The JAX package stays beside it as the reference.  The port mirrors its
module layout and names, imports ``torch`` and never ``jax``, and replaces
each Pallas TPU kernel with a CUDA kernel written for Hopper (``sm_90a``),
keeping a plain PyTorch version of each kernel beside it for the CPU and as
the test oracle.

Ported so far (the pofusion teacher's serving path, train step and CV
drivers, and the masked teacher's saliency masks):

- ``config``    the ``Options`` flag surface (own copy)
- ``models``    ResNet18 (with ``--paired_conv``), MaxNet, BilinearFusion,
                PathomicModel, and the weight bridge to and from the JAX
                package's flax trees
- ``ops``       the Kronecker-fusion kernels: the eval and the masked train
                forward (one kernel, ``csrc/kron_fusion.cu``), the eval
                backward (``csrc/kron_bwd.cu``); the stage-1 3x3
                convolution (``csrc/conv3x3.cu``)
- ``data``      CV splits, contrast sampling, the host loaders with device
                prefetch, the native JPEG decoder, on-device augmentation
- ``losses``    NLL, Cox, L1, pred-KD, DistillKL, SP, orth
- ``masking``   the superpixel saliency masks of the masked teacher
- ``contrast``  the classic CRD memory bank and NCE loss
- ``train``     the teacher's train and eval steps, the fold loop, Adam and
                the LR schedules (plateau included), EMA, and the
                train-state bridge to the JAX package
- ``eval``      grading and survival metrics (numpy/scipy), prediction dumps
- ``utils``     fold checkpoints in the JAX package's pickle layout,
                train-state snapshots, the JSONL metrics log
- ``serve``     the eval forward and its ``torch.save`` artifact
- ``cli``       ``train_cv_MT``, ``test_cv_MT``, ``export_model``, ``predict``
"""

__version__ = "0.3.0"
