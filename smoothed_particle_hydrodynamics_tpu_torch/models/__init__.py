from .scenes import SCENES, make_scene

__all__ = ["SCENES", "make_scene"]
