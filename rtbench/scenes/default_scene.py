"""Scene generator `default_scene`: the reference app's start-up world
(zig_vulkan src/main.zig: perlin terrain from `terrain_seed` with
`terrain_materials`, and optionally the demo model at `model_offset`),
built by the reference's frozen copy of the port's scene code
(`rtbench.ref.models.scenes`, `rtbench.ref.io.terrain`)."""

from rtbench.ref.config import GridConfig
from rtbench.ref.core.grid import BrickGrid
from rtbench.ref.core.materials import fill_from_vox_palette, terrain_materials
from rtbench.ref.io import terrain
from rtbench.ref.models import scenes


def build(scene: dict):
    """(grid, materials) of the reference package for a configuration's
    "scene" entry."""
    if scene["materials"] != "terrain_materials":
        raise ValueError(f"unknown material table {scene['materials']!r}")
    grid = BrickGrid(*scene["grid_dims"], GridConfig(
        min_point=tuple(scene["min_point"]), scale=scene["scale"],
        workers_count=4))
    materials = terrain_materials()
    if scene.get("model") == "demo_model":
        model = scenes.demo_model()
        fill_from_vox_palette(materials, model.palette)
        grid.attach_materials(materials)
        scenes.insert_vox_model(grid, model, tuple(scene["model_offset"]))
    elif scene.get("model") is None:
        grid.attach_materials(materials)
    else:
        raise ValueError(f"unknown model {scene['model']!r}")
    terrain.generate(grid, seed=scene["terrain_seed"],
                     scale=scene["terrain_noise_scale"],
                     ocean_level=scene["ocean_level"])
    return grid, materials
