"""Multi-task PEFT on a shared backbone: BaseOp hooks, the method registry
and the stacked multi-task adapters."""
