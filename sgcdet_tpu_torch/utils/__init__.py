"""Host utilities of the port (sgcdet_tpu/utils/): the show mode's dumps
and wireframe renders."""
from .visualize import denormalize_images, draw_boxes_2d, draw_scene_2d, dump_show_results

__all__ = ["denormalize_images", "draw_boxes_2d", "draw_scene_2d", "dump_show_results"]
