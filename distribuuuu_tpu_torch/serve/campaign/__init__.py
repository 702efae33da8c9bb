"""Traffic-campaign plane (counterpart of distribuuuu_tpu/serve/campaign/):
multi-model fleet multiplexing and trace-driven serving campaigns.

``dsl``    — campaign YAML → seeded deterministic request schedule.
``fleet``  — MultiModelFleet: one router, per-model replica pools.
``runner`` — replay a schedule against a real fleet, alert-rule referee.

``python -m distribuuuu_tpu_torch.serve_campaign`` composes all three.
"""

from distribuuuu_tpu_torch.serve.campaign.dsl import (  # noqa: F401
    CampaignSpec,
    build_schedule,
    load_campaign,
    parse_campaign,
    schedule_hash,
)
from distribuuuu_tpu_torch.serve.campaign.runner import CampaignRunner  # noqa: F401
