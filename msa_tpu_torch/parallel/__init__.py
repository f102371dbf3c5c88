"""Work distribution of the port: schedules, cost model, devices, engine."""

from msa_tpu_torch.parallel.schedule import lpt_schedule, pair_costs, schedule_for  # noqa: F401
from msa_tpu_torch.parallel.mesh import local_devices  # noqa: F401
from msa_tpu_torch.parallel.engine import (  # noqa: F401
    align_kway_sharded,
    init_distributed,
    sharded_pair_scores,
)
