"""DiT training: LR schedules, train state and the train step."""
