"""Round 4: always-on per-stage FrameStats (stats_every) + structured
logging (utils/log, ≙ Lumen Log.h spdlog wrapper + FrameStats map)."""
import logging

import numpy as np

from lumenrenderer_tpu.integrator.wavefront import RenderConfig
from lumenrenderer_tpu.render.renderer import Renderer
from lumenrenderer_tpu.scene import presets
from lumenrenderer_tpu.utils import log as log_mod


def test_stats_every_fills_per_stage_map():
    scene, camf = presets.cornell_box(with_blocks=True)
    sc, cam = scene.build(), camf(1.0)
    cfg = RenderConfig(width=16, height=16, max_depth=2, bsdf="lambert",
                       light_strategy="nee", rr_start_depth=99,
                       sort_secondary=False)
    r = Renderer(sc, cfg, accel="tiled", interpret=True, stats_every=2)
    st = r.init_state(0)
    for _ in range(3):
        st, _ = r.render_frame(st, cam)
    stats = r.get_last_frame_stats()
    # the reference's per-stage keys have live equivalents every frame
    for k in ("Total Frame Time", "Intersect (primary, coherent)",
              "ExtractSurfaceData", "GeneratePrimaryRays"):
        assert k in stats, (k, sorted(stats))
        assert stats[k] >= 0.0


def test_frame_record_structured_line(caplog):
    with caplog.at_level(logging.DEBUG, logger="lumen.core"):
        lg = log_mod.core()
        lg.propagate = True  # let caplog capture
        try:
            log_mod.frame_record({"Total Frame Time": 12.5, "Frame": 3})
        finally:
            lg.propagate = False
    assert any("Total_Frame_Time=12.500" in rec.message or
               "Total_Frame_Time" in rec.getMessage()
               for rec in caplog.records)


def test_core_client_loggers_exist():
    assert log_mod.core().name == "lumen.core"
    assert log_mod.client().name == "lumen.client"
