"""The port's launchers: `python -m repro_torch.launch.train --arch <id>`
and `python -m repro_torch.launch.serve --arch <id>`."""
