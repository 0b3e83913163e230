"""Model zoo of the port: the unified decoder LM (dense, MoE and VLM
families), the encoder-decoder (seamless) and the state-space families
(rwkv6, zamba2), layers stacked on a leading axis."""

from .api import BatchSpec, ModelAPI, model_api
from .convert import decode_state_from_numpy, params_from_numpy
from .shardlib import ParamSpec, init_param_tree, param_count, shard

__all__ = ["BatchSpec", "ModelAPI", "model_api", "ParamSpec",
           "init_param_tree", "param_count", "shard", "params_from_numpy",
           "decode_state_from_numpy"]
