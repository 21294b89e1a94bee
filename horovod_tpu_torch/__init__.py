"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu for H100s.

It imports torch and numpy, never JAX, and nothing of ``horovod_tpu``.
Entry points run on the CUDA card unless ``device="cpu"`` is asked for.
The eager Horovod API (``hvd.init()``, ``hvd.allreduce`` ..., from
``eager.py``) takes CPU tensors and CUDA tensors on this rank's card,
which ride the NCCL device plane and never the host;
``horovod_tpu_torch.torch`` is the torch binding on top of it
(``DistributedOptimizer``, ``broadcast_parameters``, ``SyncBatchNorm``).
"""
__version__ = "0.1.0"

from . import eager, models, parallel, serving, training
from .eager import *  # noqa: F401,F403 - the Horovod API at package level
from .models import (VGG, VGG16, VGG19, InceptionV3, ResNet, ResNet18,
                     ResNet34, ResNet50, ResNet101, ResNet152,
                     TransformerConfig, TransformerLM, gpt_small, gpt_tiny)
from .ops.flash_attention import flash_attention, flash_attention_with_lse
from .parallel import GradSyncConfig, MeshSpec, build_mesh, sync_gradients
from .serving import (AdmissionController, Assignment, BatchPlan,
                      ContinuousBatcher, KVBlockPool, ReplicaExecutor,
                      RequestQueue, ServeConfig, ServeRequest)
from .training import (Trainer, TrainState, synthetic_image_batch,
                       synthetic_text_batch)

__all__ = ["eager", "models", "parallel", "serving", "training",
           "TransformerConfig", "TransformerLM", "gpt_small", "gpt_tiny",
           "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "VGG", "VGG16", "VGG19", "InceptionV3",
           "flash_attention", "flash_attention_with_lse", "GradSyncConfig",
           "MeshSpec", "build_mesh", "sync_gradients", "Trainer",
           "TrainState", "synthetic_text_batch", "synthetic_image_batch",
           "AdmissionController", "Assignment", "BatchPlan",
           "ContinuousBatcher", "KVBlockPool", "ReplicaExecutor",
           "RequestQueue", "ServeConfig", "ServeRequest", *eager.__all__]
