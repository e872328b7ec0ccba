"""Single-device training: the train step, checkpoints and the
fault-tolerant loop."""
