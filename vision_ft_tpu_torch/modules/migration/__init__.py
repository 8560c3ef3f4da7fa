from .scale import MigrationScaleFromZero

__all__ = ["MigrationScaleFromZero"]
