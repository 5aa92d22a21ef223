"""Canvas projection: pure functions from game state to the reference's
items[]/AgentState UI contract."""
