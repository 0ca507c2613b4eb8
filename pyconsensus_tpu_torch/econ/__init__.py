"""pyconsensus_tpu_torch.econ — the adversarial market economy
(``pyconsensus_tpu/econ``): adaptive cartel strategies, a multi-round
economy harness driving the live serve tier, and an economic scoreboard
reporting cartel ROI / honest-reporter yield / time-to-catch alongside
service SLOs.

Quick use::

    from pyconsensus_tpu_torch.econ import MarketEconomy, build_scenario
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    svc = ConsensusService(ServeConfig()).start()   # device="cpu" on request
    result = MarketEconomy(svc, build_scenario(seed=7)).run()
    print(result["per_strategy"]["camouflage"]["cartel_roi"])
    svc.close(drain=True)

CLI front door: ``pyconsensus-econ-torch`` or ``python -m
pyconsensus_tpu_torch.econ`` (see ``econ.cli``). Strategies, panels and
plans are host numpy, equal to the reference's bit for bit; the
resolutions run on the serve front door's device.
"""

from __future__ import annotations

from .economy import (MarketEconomy, MarketSpec, Scenario, build_scenario,
                      round_panel, split_blocks)
from .scoreboard import Scoreboard, mechanism_digest
from .strategies import (STRATEGIES, CartelStrategy, RoundPlan,
                         StrategyContext, make_strategy, strategy_rng)

__all__ = ["MarketEconomy", "MarketSpec", "Scenario", "build_scenario",
           "round_panel", "split_blocks", "Scoreboard",
           "mechanism_digest", "STRATEGIES", "CartelStrategy",
           "RoundPlan", "StrategyContext", "make_strategy",
           "strategy_rng"]
