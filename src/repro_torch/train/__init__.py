"""Square-routed training: the loss, the train step and its guard, fault
injection and the fault-tolerant trainer."""
