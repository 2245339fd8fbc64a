from minigrid_dynamicprogramming_tpu_torch.models.nets import (
    ActorCritic,
    ObsEncoder,
    init_params,
)
from minigrid_dynamicprogramming_tpu_torch.models.ppo import (
    PPO,
    PPOConfig,
    TrainState,
    train,
)

__all__ = [
    "ActorCritic",
    "ObsEncoder",
    "init_params",
    "PPO",
    "PPOConfig",
    "TrainState",
    "train",
]
