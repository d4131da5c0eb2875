"""DyMoE core: depth schedule, importance, prefetch (torch port)."""
