"""World state: map store, keyframe policy, fused frontend, pipeline."""
