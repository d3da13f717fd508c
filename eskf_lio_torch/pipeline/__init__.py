"""pipeline of the PyTorch port (mirrors `eskf_lio_tpu/pipeline/`).

Importing the pipeline pins float32 matrix products to full precision on
the card: the JAX package runs its covariance algebra at
`precision="highest"` because reduced precision (TF32 here) ruins the
18×18 covariance at 1e-3 scale.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
