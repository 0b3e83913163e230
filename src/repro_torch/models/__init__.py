"""Model zoo of the port: the unified decoder LM, dense family so far,
layers stacked on a leading axis."""

from .api import ModelAPI, model_api
from .convert import decode_state_from_numpy, params_from_numpy
from .shardlib import ParamSpec, init_param_tree, param_count, shard

__all__ = ["ModelAPI", "model_api", "ParamSpec", "init_param_tree",
           "param_count", "shard", "params_from_numpy",
           "decode_state_from_numpy"]
