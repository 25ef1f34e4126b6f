"""Launch layer: the train and serve step factories and the training CLI."""
