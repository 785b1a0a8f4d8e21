"""auformer_torch — the PyTorch/CUDA port of auformer for NVIDIA Hopper.

A second package beside the JAX one (``auformer``), which it mirrors module
by module and is tested against. It imports ``torch`` and numpy only.

- ``auformer_torch.core``   config (opts-compatible CLI), weight import,
                            checkpoints, seeds, step timing
- ``auformer_torch.ops``    clip preprocessing, the device AutoAugment,
                            the log-mel frontend and short-sequence
                            attention (with its gradient), each kernel
                            with a hand-written CUDA source under ``csrc/``
- ``auformer_torch.nn``     avformer (two-stream aural-visual former)
- ``auformer_torch.losses`` / ``metrics``  the loss suites, the scores
- ``auformer_torch.data``   FrameStores and their native JPEG reader, the
                            split, the datasets, samplers and loader
- ``auformer_torch.infer``  clip-batch and dense-sweep inference over
                            arrays or a dataset, submission writers
- ``auformer_torch.sweep``  the dense sweep (trunk once per frame)
- ``auformer_torch.serve``  decode -> sweep streaming, the decode worker
- ``auformer_torch.parallel``  the train and eval steps
- ``auformer_torch.train_lib``  the training loop
- ``auformer_torch.test_aff2`` / ``train``  the inference and training
                            entry points

Output convention (reference train.py:135-138): every model maps a batch
dict to a ``(B, 21)`` tensor laid out ``[AU 0:12 | EX 12:19 | VA 19:21]``.
"""

__version__ = "0.1.0"

AU_NAMES = ("AU1", "AU2", "AU4", "AU6", "AU7", "AU10",
            "AU12", "AU15", "AU23", "AU24", "AU25", "AU26")
NUM_AU = 12
NUM_EX = 7
NUM_VA = 2
OUT_DIM = NUM_AU + NUM_EX + NUM_VA  # 21

# label sentinels (reference aff2compdataset.py:264-287)
AU_IGNORE = -1
EX_IGNORE = -1          # remapped to 7 at loss time (reference train.py:126,208)
EX_IGNORE_REMAPPED = 7
VA_IGNORE = -5.0
