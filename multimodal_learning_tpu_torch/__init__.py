"""multimodal_learning_tpu_torch — the PyTorch/CUDA port of
``multimodal_learning_tpu`` for one NVIDIA H100.

The JAX package stays beside it as the reference.  The port mirrors its
module layout and names, imports ``torch`` and never ``jax``, and replaces
each Pallas TPU kernel with a CUDA kernel written for Hopper (``sm_90a``),
keeping a plain PyTorch version of each kernel beside it for the CPU and as
the test oracle.

Ported: every module of the JAX package but ``parallel/`` (the device
mesh), with every flow of the three papers, offline evaluation and the
BASELINE recipes and sweep:

- ``config``    the ``Options`` flag surface (own copy)
- ``models``    ResNet18 (with ``--paired_conv``), ResNet34/50, MaxNet,
                BilinearFusion, PathomicModel, the weight bridge to and
                from the JAX package's flax trees, checkpoint import
                (``--pretrained_path``) and ``--init_type``
- ``ops``       the Kronecker-fusion kernels: the eval and the masked train
                forward (one kernel, ``csrc/kron_fusion.cu``), the eval
                backward (``csrc/kron_bwd.cu``); the stage-1 3x3
                convolution (``csrc/conv3x3.cu``)
- ``data``      CV splits, contrast sampling, the host loaders with device
                prefetch, the native JPEG decoder, on-device augmentation,
                the TCGA CSV cleaning (pandas, library-level)
- ``losses``    NLL, Cox, L1, pred-KD, DistillKL, SP, orth
- ``masking``   the superpixel saliency masks of the masked teacher
- ``contrast``  the CRD memory banks (classic, and the students' v2/v3/v4
                selection), the NCE loss and the loss-gated CRD
- ``gradweight`` the AEKD / GK-Refine teacher weightings from feature and
                parameter gradients
- ``lowrank``   the M3LR t-SVT operator and its view adjacencies
- ``train``     the teacher's train and eval steps (t-SVD included), the
                student's step and fold loop, the teacher's fold loop, Adam,
                AdaBound, Adagrad and the LR schedules (plateau and
                onecycle included), EMA, and the
                train-state bridge to the JAX package
- ``eval``      grading and survival metrics (numpy/scipy), prediction dumps,
                patient-level aggregation and CIs, ROI and survival
                analysis (pandas), the Cox fitter, the plots (matplotlib)
- ``recipes``   the BASELINE presets (``get_recipe``)
- ``utils``     fold checkpoints in the JAX package's pickle layout,
                train-state snapshots, the JSONL metrics log
- ``serve``     the eval forward and its ``torch.export`` artifact
- ``cli``       ``train_cv_MT``, ``test_cv_MT``, ``train_cv_path_multi_MT``,
                ``test_cv_path``, ``train_cv_MT_SP_Masking``,
                ``train_cv_path_CLAT``, ``export_model``, ``predict``,
                ``convert_torch``, ``evaluation_GBMLGG``,
                ``ROI_evaluation``, ``sweep``
"""

__version__ = "0.4.0"
