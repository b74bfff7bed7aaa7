from .scenes import SCENES, make_scene, scene_config

__all__ = ["SCENES", "make_scene", "scene_config"]
