from .reactive import InvokerReactive, InvokerReactiveProvider

__all__ = ["InvokerReactive", "InvokerReactiveProvider"]
