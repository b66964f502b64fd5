"""Experiment metrics: the confusion matrix and the segmentation tracker."""
