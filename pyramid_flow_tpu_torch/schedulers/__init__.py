from .cosine_ddpm import (SCHEDULER_REGISTRY, DDPMCosineScheduler,
                          get_scheduler)
from .flow_matching import PyramidFlowMatchEulerDiscreteScheduler
