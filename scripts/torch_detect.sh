# The PyTorch/CUDA port's detect CLI (python -m ryolo_tpu_torch.detect; add
# --device cpu to run on the CPU)
python -m ryolo_tpu_torch.detect --data configs/UCAS_AOD.yaml --hyp configs/hyp.yaml --weight_path weights/mkiou2/best.pth --batch_size 8 --img_size 608 --conf_thres 0.8
