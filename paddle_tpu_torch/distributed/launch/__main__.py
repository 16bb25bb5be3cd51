from paddle_tpu_torch.distributed.launch import main

if __name__ == "__main__":
    main()
