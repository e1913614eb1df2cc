from .base import ALL_ARCHS, SHAPES, ArchConfig, ShapeSpec, cells_for, get_config

__all__ = ["ALL_ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "cells_for", "get_config"]
