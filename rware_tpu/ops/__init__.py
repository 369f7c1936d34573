from rware_tpu.ops.resolver import resolve_moves

__all__ = ["resolve_moves"]
