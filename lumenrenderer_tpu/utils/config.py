"""Run-time application configuration (JSON).

Equivalent of `AppConfiguration` (`Sandbox/src/AppConfiguration.h`
+ `AppConfigKeys.h` + defaults `AppConfigDefaults.h:1-11`): a JSON file with
asset/scene paths, resolution, depth, renderer toggles; missing file →
defaults written (the reference does the same). Feeds `RenderConfig` +
`Renderer` directly.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class AppConfig:
    scene_path: str = ""                 # .gltf/.glb or "" for built-in preset
    preset: str = "cornell"              # cornell | interior | furnace
    render_resolution: Tuple[int, int] = (1280, 720)   # ≙ shipped default
    output_resolution: Tuple[int, int] = (1280, 720)
    max_depth: int = 5                   # ≙ Config.json depth=5
    spp: int = 32
    bsdf: str = "disney"
    light_strategy: str = "mis"
    use_restir: bool = False
    denoise: bool = False
    accel: str = "tiled"                 # the bench's intersector
    exposure: float = 1.0
    tonemap: str = "gamma"               # gamma | aces
    output_path: str = "out.png"
    seed: int = 0

    @staticmethod
    def load(path: str) -> "AppConfig":
        if not os.path.exists(path):
            cfg = AppConfig()
            cfg.save(path)
            return cfg
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(AppConfig)}
        data = {k: v for k, v in data.items() if k in known}
        for k in ("render_resolution", "output_resolution"):
            if k in data:
                data[k] = tuple(data[k])
        return AppConfig(**data)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
