"""repro_torch.models — the LM substrate on PyTorch (serving, and the
training that ``repro_torch.train`` drives): the
transformer (dense GQA; MoE with its top-k and dodoor expert routers; the
qwen2-vl VLM backbone with M-RoPE), Mamba-2, the RecurrentGemma RG-LRU
hybrid and Whisper, with the reference's parameter trees and entry points
(``registry``).  Attention layers launch the flash attention kernel K7 and
Mamba-2 mixers the SSD chunk kernel K8 on the card; on the CPU they run
the plain versions."""
from . import (common, convert, mamba2, precision, registry, rglru,
               transformer, whisper)
from .convert import params_from_numpy, train_state_from_numpy
from .registry import (decode_step, forward, init_cache, init_params, module,
                       prime_cache)

__all__ = ["common", "convert", "mamba2", "precision", "registry", "rglru",
           "transformer", "whisper", "decode_step", "forward", "init_cache",
           "init_params", "module", "params_from_numpy", "prime_cache",
           "train_state_from_numpy"]
