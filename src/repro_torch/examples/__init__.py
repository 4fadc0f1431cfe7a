"""The port's examples: `quickstart` (the programming model), `rl_pipeline`
(the paper's RL loop, its policy on the card) and `rl_workload` (the
paper's §4.2 runs: serial, BSP and hybrid executors)."""
